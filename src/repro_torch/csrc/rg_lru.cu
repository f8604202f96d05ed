// Fused RG-LRU (Griffin / RecurrentGemma) gates and linear recurrence:
//   a_t = exp(-c * softplus(a_param) * sigmoid(a_gate_t))
//   h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) * (sigmoid(x_gate_t) * x_t)
// over x, a_gate, x_gate (B, T, D), a_param (D,), h0 (B, D); writes out
// (B, T, D) in x's dtype and h_T (B, D) in fp32.
//
// Replaces the TPU kernel src/repro/kernels/rg_lru.py::rg_lru.  Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a library with the plain C interface at the bottom of this file,
// loaded from Python with ctypes (src/repro_torch/kernels/build.py).
//
// Work decomposition.  The TPU grid walks (batch row, time chunk) and
// carries h in VMEM across the sequential chunk axis.  Here the recurrence
// is independent per (batch row, channel), so one thread owns one channel
// of one batch row and carries h in an fp32 register over all T steps; the
// chunk length ct changes no result (the wrapper only validates it).  A
// block's threads hold consecutive channels, so every step's loads and
// stores are coalesced along D.
//
// Bound.  One read of each input element and one write of each output
// element: at RecurrentGemma-9B's width (B = 4, T = 2048, D = 4096) 268 MB
// in bf16 (80 us at 3.35 TB/s) and 537 MB in fp32 (160 us); the gate math
// is ~40 operations an element, far below the fp32 rate.  So bytes bind,
// and the loop must keep enough loads in flight: with one thread per
// channel only B * D threads exist (16,384 at that width), and a loop that
// waited on each step's own load would be latency-bound.  The loop
// therefore runs in chunks of kSteps steps: the next chunk's three inputs
// are loaded into registers (independent loads, all issued together)
// before the current chunk's gates and recurrence are computed, so each
// thread keeps kSteps * 3 loads in flight while it computes.  With only
// a few warps on each SM, the gate math (two sigmoids, an exp and a sqrt a
// step) must overlap across the steps of a chunk inside one thread: whole
// chunks run without per-step guards, and the last T % kSteps steps one at
// a time.
//
// Numerics follow the TPU kernel: every input is converted to fp32 first,
// softplus is written stably as max(p, 0) + log1p(exp(-|p|)) (jax.nn.
// softplus is logaddexp(p, 0)), and expf/log1pf/sqrtf are the accurate
// library functions (no fast-math intrinsics).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;   // channels per block
constexpr int kSteps = 16;     // time steps per register chunk

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

template <typename TI>
__global__ void __launch_bounds__(kThreads) rg_lru_kernel(
    const TI* __restrict__ x, const TI* __restrict__ a_gate,
    const TI* __restrict__ x_gate, const float* __restrict__ a_param,
    const float* __restrict__ h0, TI* __restrict__ out,
    float* __restrict__ h_t, int T, int D, float c) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  const long long row = static_cast<long long>(b) * T * D + d;
  const float p = a_param[d];
  const float neg_c_sp = -c * (fmaxf(p, 0.f) + log1pf(expf(-fabsf(p))));
  float h = h0[static_cast<long long>(b) * D + d];

  // one step: gates from the three inputs, then the recurrence
  auto gate = [&](float xs, float ag, float xg, float& a, float& xb) {
    a = expf(neg_c_sp * sigmoid(ag));
    const float beta = sqrtf(fmaxf(1.f - a * a, 1e-12f));
    xb = beta * (sigmoid(xg) * xs);
  };
  // Whole chunks run without per-step guards, so each chunk's loads, gate
  // math and stores form one straight-line block the compiler interleaves;
  // the next whole chunk's loads are issued before this one is computed.
  float xv[kSteps], av[kSteps], gv[kSteps];
  auto load = [&](int t0, float* xr, float* ar, float* gr) {
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const long long i = row + static_cast<long long>(t0 + s) * D;
      xr[s] = to_f32(x[i]);
      ar[s] = to_f32(a_gate[i]);
      gr[s] = to_f32(x_gate[i]);
    }
  };
  const int full = T - T % kSteps;   // steps in whole chunks
  if (full > 0) load(0, xv, av, gv);
  for (int t0 = 0; t0 < full; t0 += kSteps) {
    float xn[kSteps], an[kSteps], gn[kSteps];
    if (t0 + kSteps < full) load(t0 + kSteps, xn, an, gn);   // in flight
    float a[kSteps], xb[kSteps];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) gate(xv[s], av[s], gv[s], a[s], xb[s]);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      h = a[s] * h + xb[s];
      store_as(out + row + static_cast<long long>(t0 + s) * D, h);
    }
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      xv[s] = xn[s];
      av[s] = an[s];
      gv[s] = gn[s];
    }
  }
  for (int t = full; t < T; ++t) {   // the last T % kSteps steps
    const long long i = row + static_cast<long long>(t) * D;
    float a, xb;
    gate(to_f32(x[i]), to_f32(a_gate[i]), to_f32(x_gate[i]), a, xb);
    h = a * h + xb;
    store_as(out + i, h);
  }
  h_t[static_cast<long long>(b) * D + d] = h;
}

template <typename TI>
int launch(const void* x, const void* a_gate, const void* x_gate,
           const float* a_param, const float* h0, void* out, float* h_t,
           int B, int T, int D, float c, cudaStream_t stream) {
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  rg_lru_kernel<TI><<<grid, kThreads, 0, stream>>>(
      static_cast<const TI*>(x), static_cast<const TI*>(a_gate),
      static_cast<const TI*>(x_gate), a_param, h0, static_cast<TI*>(out),
      h_t, T, D, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, a_gate, x_gate, out: (B, T, D) contiguous, all fp32 (bf16 = 0) or all
// bf16 (bf16 = 1); a_param (D,), h0 (B, D), h_t (B, D): contiguous fp32.
// Returns 0, a cudaError_t value, or -1 for a shape out of range.
int rg_lru(const void* x, const void* a_gate, const void* x_gate,
           const float* a_param, const float* h0, void* out, float* h_t,
           int B, int T, int D, float c, int bf16, void* stream) {
  if (B < 1 || T < 1 || D < 1 || B > 65535) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, a_gate, x_gate, a_param, h0, out,
                                      h_t, B, T, D, c, s)
              : launch<float>(x, a_gate, x_gate, a_param, h0, out, h_t, B,
                              T, D, c, s);
}

const char* rg_lru_error_string(int code) {
  if (code == -1) return "shape out of range (B must be 1..65535)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
