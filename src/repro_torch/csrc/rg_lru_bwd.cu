// Backward pass of the fused RG-LRU (Griffin / RecurrentGemma) gates and
// recurrence of rg_lru.cu:
//   s_t = sigmoid(a_gate_t), a_t = exp(ncs * s_t), ncs = -c softplus(a_param)
//   i_t = sigmoid(x_gate_t), beta_t = sqrt(max(1 - a_t^2, 1e-12))
//   h_t = a_t h_{t-1} + beta_t i_t x_t
// Given dout (B, T, D) in x's dtype, dh_T (B, D) fp32, the forward's h in
// fp32 (hs, (B, T, D)) and h0, it walks T in reverse:
//   g_t = dout_t + a_{t+1} g_{t+1}   (g_{T-1} = dout_{T-1} + dh_T)
//   dA_t = g_t h_{t-1} + g_t i_t x_t dbeta/da   (dbeta/da = -a / beta, and 0
//          on the clamped side of max(., 1e-12), as jax.grad gives it)
//   dx_t = g_t beta_t i_t,  dx_gate_t = g_t beta_t x_t i_t (1 - i_t)
//   da_gate_t = dA_t a_t ncs s_t (1 - s_t)
//   da_param = -c sigmoid(a_param) sum_{b,t} dA_t a_t s_t,  dh0 = a_0 g_0
// and writes dx, da_gate, dx_gate in their inputs' dtypes, da_param (D,)
// and dh0 (B, D) in fp32.
//
// No Pallas kernel has this backward: repro takes jax.grad of the
// lax.scan in src/repro/models/recurrent.py::rglru_block_apply (and of
// src/repro/kernels/ref.py::rg_lru_ref).  This kernel stands where that
// gradient is taken; built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a library with the plain C interface at the bottom of this file,
// loaded from Python with ctypes (src/repro_torch/kernels/build.py).
//
// Bound.  Each input read once and each output written once: x, a_gate,
// x_gate and dout in their dtypes, h in fp32, dx, da_gate, dx_gate in their
// dtypes: 18 bytes an element in bf16, 32 in fp32 (RecurrentGemma-9B's
// 1 x 4096 x 4096 bf16 call: 302 MB, 90 us at 3.35 TB/s).  The gate math is
// the forward's (two sigmoids, an exp, a sqrt) plus a division an element.
// As in the forward, bytes bind and g is a serial chain per (batch row,
// channel).
//
// Design (a first, simple kernel: no TMA ring, no warp specialisation).
// One block of 256 threads owns one (batch row, tile of kDt = 16 channels)
// and walks T backwards in tiles of kL = 64 steps.  Per tile: (1) every
// thread loads its 4 elements (a warp reads two steps of 16 consecutive
// channels), computes the gates in fp32 and puts a_t and dout_t into
// shared memory (steps past T take a = 1, dout = 0, so the chain passes
// through them); (2) 16 threads, one a channel, walk the tile's steps in
// reverse, g = dout + G, G = a g, leaving g in shared memory (the carry G
// stays in their registers across tiles); (3) every thread forms its
// elements' gradients from g and its registers and stores them.  The h
// that the chain needs is the forward's own fp32 h (the wrapper runs the
// forward with an fp32 x when gradients are recorded, which gives the same
// h bit for bit), never h recovered by inverting the step, which is
// unstable where a_t is small.  da_param is deterministic: each thread sums
// its elements over T, the block adds its threads' sums per channel in a
// fixed order into a (B, D) scratch, and a second kernel adds that over B
// in order and applies -c sigmoid(a_param).  No atomics: the same result
// on every run.  Math as the forward: expf, log1pf, sqrtf and true
// division, no fast-math.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kDt = 16;                        // channels of one block
constexpr int kL = 64;                         // time steps of one tile
constexpr int kThreads = 256;
constexpr int kRowsPerPass = kThreads / kDt;   // steps a pass of the block covers
constexpr int kPer = kDt * kL / kThreads;      // elements a thread, a tile
constexpr int kChainUnroll = 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store_as(__half* p, float v) {
  *p = __float2half(v);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// -c * softplus(p), as the forward writes it
__device__ __forceinline__ float neg_c_softplus(float p, float c) {
  return -c * (fmaxf(p, 0.f) + log1pf(expf(-fabsf(p))));
}

template <typename TX, typename TA, typename TG>
__global__ void __launch_bounds__(kThreads) rg_lru_bwd_tile(
    const TX* __restrict__ x, const TA* __restrict__ a_gate,
    const TG* __restrict__ x_gate, const TX* __restrict__ dout,
    const float* __restrict__ hs, const float* __restrict__ h0,
    const float* __restrict__ dh_t, const float* __restrict__ a_param,
    TX* __restrict__ dx, TA* __restrict__ dag, TG* __restrict__ dxg,
    float* __restrict__ dh0, float* __restrict__ part, int T, int D,
    int d_tiles, float c) {
  __shared__ float a_s[kL][kDt];   // a_t of the tile
  __shared__ float g_s[kL][kDt];   // dout_t, then g_t
  __shared__ float red[kThreads];

  const int b = blockIdx.x / d_tiles;
  const int c0 = (blockIdx.x % d_tiles) * kDt;
  const int tid = threadIdx.x;
  const int cl = tid % kDt;          // the thread's channel, every tile
  const int ch = c0 + cl;
  const bool live = ch < D;
  const long long bd = static_cast<long long>(b) * D + ch;
  const long long base = static_cast<long long>(b) * T * D + ch;
  const float ncs = live ? neg_c_softplus(a_param[ch], c) : 0.f;
  float pacc = 0.f;                  // sum of dA a s over the thread's elements
  float carry = (tid < kDt && live) ? dh_t[bd] : 0.f;   // G, chain threads

  const int n_tiles = (T + kL - 1) / kL;
  for (int it = n_tiles - 1; it >= 0; --it) {
    const int t0 = it * kL;
    float xv[kPer], sv[kPer], av[kPer], iv[kPer], hp[kPer];
    // (1) loads and gates of the thread's elements
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int s = tid / kDt + kRowsPerPass * k;
      const int t = t0 + s;
      const bool ok = live && t < T;
      const long long i = base + static_cast<long long>(t) * D;
      float xx = 0.f, ag = 0.f, xg = 0.f, dv = 0.f, hprev = 0.f;
      if (ok) {
        xx = to_f32(x[i]);
        ag = to_f32(a_gate[i]);
        xg = to_f32(x_gate[i]);
        dv = to_f32(dout[i]);
        hprev = t == 0 ? h0[bd] : hs[i - D];
      }
      const float sg = sigmoid(ag);
      const float a = ok ? expf(ncs * sg) : 1.f;
      xv[k] = xx;
      sv[k] = sg;
      av[k] = a;
      iv[k] = sigmoid(xg);
      hp[k] = hprev;
      a_s[s][cl] = a;
      g_s[s][cl] = dv;
    }
    __syncthreads();
    // (2) the reverse chain, one thread a channel
    if (tid < kDt) {
      float g_c = carry;
#pragma unroll 1
      for (int s1 = kL; s1 > 0; s1 -= kChainUnroll) {
        float av_[kChainUnroll], dv_[kChainUnroll];
#pragma unroll
        for (int u = 0; u < kChainUnroll; ++u) {
          av_[u] = a_s[s1 - 1 - u][tid];
          dv_[u] = g_s[s1 - 1 - u][tid];
        }
#pragma unroll
        for (int u = 0; u < kChainUnroll; ++u) {
          const float g = dv_[u] + g_c;
          g_s[s1 - 1 - u][tid] = g;
          g_c = av_[u] * g;
        }
      }
      carry = g_c;
    }
    __syncthreads();
    // (3) the elements' gradients
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int s = tid / kDt + kRowsPerPass * k;
      const int t = t0 + s;
      if (!live || t >= T) continue;
      const long long i = base + static_cast<long long>(t) * D;
      const float g = g_s[s][cl];
      const float a = av[k], sg = sv[k], ig = iv[k], xx = xv[k];
      const float one_m = fmaf(-a, a, 1.f);
      const float beta = sqrtf(fmaxf(one_m, 1e-12f));
      const float dbeta = one_m > 1e-12f ? -a / beta : 0.f;
      const float gb = g * beta;
      const float d_a = fmaf(g * ig * xx, dbeta, g * hp[k]);
      const float das = d_a * a * sg;                     // dL/dncs share
      store_as(dx + i, gb * ig);
      store_as(dxg + i, gb * xx * ig * (1.f - ig));
      store_as(dag + i, das * ncs * (1.f - sg));
      pacc += das;
    }
    __syncthreads();   // a_s and g_s are free for the next tile
  }
  if (tid < kDt && live) dh0[bd] = carry;
  // the block's per-channel sums of dA a s over T, in thread order
  red[tid] = pacc;
  __syncthreads();
  if (tid < kDt) {
    float sum = 0.f;
    for (int r = 0; r < kRowsPerPass; ++r) sum += red[r * kDt + tid];
    if (live) part[bd] = sum;
  }
}

// da_param[d] = -c sigmoid(a_param[d]) sum_b part[b, d], b in order
__global__ void rg_lru_bwd_param(const float* __restrict__ part,
                                 const float* __restrict__ a_param,
                                 float* __restrict__ da_param, int B, int D,
                                 float c) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  float sum = 0.f;
  for (int b = 0; b < B; ++b) sum += part[static_cast<long long>(b) * D + d];
  da_param[d] = -c * sigmoid(a_param[d]) * sum;
}

struct Call {
  const void *x, *a_gate, *x_gate, *dout;
  const float *hs, *h0, *dh_t, *a_param;
  void *dx, *dag, *dxg;
  float *da_param, *dh0, *part;
  int B, T, D;
  float c;
  cudaStream_t stream;
};

template <typename TX, typename TA, typename TG>
int run(const Call& k) {
  const int d_tiles = (k.D + kDt - 1) / kDt;
  if (static_cast<long long>(d_tiles) * k.B > 0x7fffffff) return -1;
  rg_lru_bwd_tile<TX, TA, TG><<<d_tiles * k.B, kThreads, 0, k.stream>>>(
      static_cast<const TX*>(k.x), static_cast<const TA*>(k.a_gate),
      static_cast<const TG*>(k.x_gate), static_cast<const TX*>(k.dout), k.hs,
      k.h0, k.dh_t, k.a_param, static_cast<TX*>(k.dx),
      static_cast<TA*>(k.dag), static_cast<TG*>(k.dxg), k.dh0, k.part, k.T,
      k.D, d_tiles, k.c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rg_lru_bwd_param<<<(k.D + 255) / 256, 256, 0, k.stream>>>(
      k.part, k.a_param, k.da_param, k.B, k.D, k.c);
  return static_cast<int>(cudaGetLastError());
}

// dtype codes: 0 fp32, 1 bf16, 2 fp16
template <typename TX, typename TA>
int pick_g(const Call& k, int g) {
  switch (g) {
    case 0: return run<TX, TA, float>(k);
    case 1: return run<TX, TA, __nv_bfloat16>(k);
    case 2: return run<TX, TA, __half>(k);
  }
  return -1;
}

template <typename TX>
int pick_a(const Call& k, int a, int g) {
  switch (a) {
    case 0: return pick_g<TX, float>(k, g);
    case 1: return pick_g<TX, __nv_bfloat16>(k, g);
    case 2: return pick_g<TX, __half>(k, g);
  }
  return -1;
}

}  // namespace

extern "C" {

// x, a_gate, x_gate, dout, dx, da_gate, dx_gate: (B, T, D) contiguous, each
// of its input's dtype (dout and dx in x's, da_gate in a_gate's, dx_gate
// in x_gate's; codes 0 fp32, 1 bf16, 2 fp16); hs (B, T, D), h0, dh_t, dh0,
// part (B, D) and a_param, da_param (D,): contiguous fp32 (part is
// scratch).  Two launches on `stream`.  Returns 0, a cudaError_t value or
// -1 for arguments out of range.
int rg_lru_bwd(const void* x, const void* a_gate, const void* x_gate,
               const void* dout, const float* hs, const float* h0,
               const float* dh_t, const float* a_param, void* dx,
               void* da_gate, void* dx_gate, float* da_param, float* dh0,
               float* part, int B, int T, int D, float c, int x_dtype,
               int a_dtype, int g_dtype, void* stream) {
  if (B < 1 || T < 1 || D < 1) return -1;
  const Call k{x,       a_gate,  x_gate,   dout, hs,  h0,   dh_t,
               a_param, dx,      da_gate,  dx_gate, da_param, dh0, part,
               B,       T,       D,        c,    static_cast<cudaStream_t>(stream)};
  switch (x_dtype) {
    case 0: return pick_a<float>(k, a_dtype, g_dtype);
    case 1: return pick_a<__nv_bfloat16>(k, a_dtype, g_dtype);
    case 2: return pick_a<__half>(k, a_dtype, g_dtype);
  }
  return -1;
}

const char* rg_lru_bwd_error_string(int code) {
  if (code == -1) return "arguments out of range";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
