// Fused RG-LRU (Griffin / RecurrentGemma) gates and linear recurrence:
//   a_t = exp(-c * softplus(a_param) * sigmoid(a_gate_t))
//   h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) * (sigmoid(x_gate_t) * x_t)
// over x, a_gate, x_gate (B, T, D), each fp32, bf16 or fp16 on its own,
// a_param (D,) and h0 (B, D) fp32; writes out (B, T, D) in x's dtype and
// h_T (B, D) in fp32.
//
// Replaces the TPU kernel src/repro/kernels/rg_lru.py::rg_lru.  Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a library with the plain C interface at the bottom of this file,
// loaded from Python with ctypes (src/repro_torch/kernels/build.py).
//
// Bound.  One read of each input element and one write of each output
// element: at RecurrentGemma-9B's width (B = 4, T = 2048, D = 4096, or
// B = 1, T = 8192) 537 MB in fp32 (160 us at 3.35 TB/s) and 268 MB in
// bf16 (80 us).  The gate math is two sigmoids, an exp and a sqrt an
// element: ~6 SFU operations (counted from the SASS of rg_lru_gate_probe
// by chip_smoke.py) at 16 a clock an SM, ~48 us at that width, and ~85
// instructions an element to issue (the gate loop's SASS), about the bf16
// byte time.  So bytes bind, with the gate math's issue close behind in
// bf16, and the kernel has to keep enough bytes in flight and spread the
// gate math over many warps while h stays a serial chain per (batch row,
// channel).
//
// Two kernels; the wrapper picks one per call from the shapes
// (kernels/rg_lru.py::choose_path):
//
// 1. tile::rg_lru_tile (path "tile"; prefill and training lengths, D a
//    multiple of 16 bytes of every operand's dtype).  One block owns one
//    (batch row, tile of Dt channels) and walks T in tiles of L steps, L *
//    Dt = kTileElems; the wrapper takes Dt = 32 where that still gives
//    twice as many blocks as SMs, else 16 (B = 1, D = 4096: 256 blocks),
//    so a single request fills the card.  Warp-specialised, 10 warps:
//    - warp 0, one thread: TMA loads (a 3-D tensor map over (B, T, D) per
//      operand, in its own dtype; a box of L x Dt; steps past T and
//      channels past D read as zeros) of the x, a_gate and x_gate tiles
//      into a kStages ring, each stage tracked by a "full" mbarrier (TMA
//      bytes) and an "empty" one (the gate warps).  The bytes in flight no
//      longer depend on how many threads carry h.
//    - warps 1-8 (two gate warpgroups): each thread takes groups of 4
//      consecutive elements of a tile, so it always sees the same 4
//      channels; it reads all of its elements of a tile in their dtypes,
//      hands the stage back, runs the gate function in fp32 on all of them
//      (independent chains) and writes (a, xb) pairs into a ring of
//      kGateStages fp32 tiles.
//    - warp 9 (the scan warp, one lane a channel): walks each gated tile's
//      steps in order with h in an fp32 register, h = fma(a, h, xb); the
//      shared-memory loads of a and xb do not depend on h and are issued
//      kUnroll steps ahead, so a step costs about one dependent FMA.  Each
//      step's h goes straight to global memory in x's dtype as a streaming
//      store (a warp stores Dt consecutive values), only the steps of T;
//      h_T after step T - 1 (never after the zero-filled steps past it).
//    Shared memory is 52 KB a block in fp32 (34 KB in bf16), so four fp32
//    blocks fit an SM and RecurrentGemma-9B's 512 blocks at B = 4 run in
//    one wave: measured (scripts/rg_lru_ablation.py), blocks that start
//    together read neighbouring channel tiles together, and a second wave
//    cost ~20 %; streaming stores and L2 promotion only for box rows
//    narrower than a line took another ~20 % off fp32, and eight gate
//    warps instead of four 5-8 % off bf16 and B = 1.  The reads alone
//    reach ~3.1 TB/s; what remains above the byte bound is the output
//    stores (~0.05 ms in fp32) and, in bf16, the gate math's issue.
// 2. simt::rg_lru_simt (path "simt"; decode, short T, and a D that TMA
//    cannot read): one thread owns one (batch row, channel) and carries h
//    over all T steps; loads of the next kSteps steps are issued before
//    the current ones are computed.
//
// Both kernels run the same gate function and the same fused step
// fma(a, h, xb), in the order of the plain version
// (kernels/rg_lru.py::rg_lru_plain, which rounds a * h before the add), so
// the two paths agree bit for bit and the plain version within 1e-5.
// Numerics follow the TPU kernel: every input is converted to fp32 first,
// softplus is written stably as max(p, 0) + log1p(exp(-|p|))
// (jax.nn.softplus is logaddexp(p, 0)), and expf, log1pf, sqrtf and the
// division are the accurate library functions (no fast-math intrinsics).
// A wait of more than 2^34 cycles on an mbarrier traps, so a fault in the
// pipeline fails the launch instead of hanging the card.
#include <cuda.h>          // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

// the checked build's operands and rings (check.cuh)
enum CkOp { kOpX = 0, kOpAg, kOpXg, kOpAParam, kOpH0, kOpOut, kOpHT };
constexpr int kRingIn = 0;     // tile: x, a_gate and x_gate boxes of a tile
constexpr int kRingGate = 1;   // tile: the (a, xb) pairs of a tile

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
// the same, as a streaming store (st.global.cs: written once, not re-read)
__device__ __forceinline__ void store_stream(float* p, float v) {
  __stcs(p, v);
}
__device__ __forceinline__ void store_stream(__nv_bfloat16* p, float v) {
  __stcs(reinterpret_cast<unsigned short*>(p),
         __bfloat16_as_ushort(__float2bfloat16(v)));
}
__device__ __forceinline__ void store_stream(__half* p, float v) {
  __stcs(reinterpret_cast<unsigned short*>(p),
         __half_as_ushort(__float2half(v)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// -c * softplus(p), once per channel
__device__ __forceinline__ float neg_c_softplus(float p, float c) {
  return -c * (fmaxf(p, 0.f) + log1pf(expf(-fabsf(p))));
}

// The gate function of one element, shared by both kernels.
__device__ __forceinline__ void gate(float ncs, float xs, float ag, float xg,
                                     float& a, float& xb) {
  a = expf(ncs * sigmoid(ag));
  const float beta = sqrtf(fmaxf(fmaf(-a, a, 1.f), 1e-12f));
  xb = beta * (sigmoid(xg) * xs);
}

// One step of the recurrence, shared by both kernels.
__device__ __forceinline__ float step(float a, float h, float xb) {
  return fmaf(a, h, xb);
}

// ---------------------------------------------------------------------------
// simt: one thread a (batch row, channel)
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kThreads = 64;   // channels per block
constexpr int kSteps = 16;     // time steps per register chunk

template <typename TX, typename TA, typename TG>
__global__ void __launch_bounds__(kThreads) rg_lru_simt(
    const TX* __restrict__ x, const TA* __restrict__ a_gate,
    const TG* __restrict__ x_gate, const float* __restrict__ a_param,
    const float* __restrict__ h0, TX* __restrict__ out,
    float* __restrict__ h_t, int T, int D, int d_blocks, float c) {
  const int b = blockIdx.x / d_blocks;
  const int d = (blockIdx.x % d_blocks) * kThreads + threadIdx.x;
  CK_BEGIN();
  CK(operand, kOpX, x, ck::kInput);
  CK(operand, kOpAg, a_gate, ck::kInput);
  CK(operand, kOpXg, x_gate, ck::kInput);
  CK(operand, kOpAParam, a_param, ck::kInput);
  CK(operand, kOpH0, h0, ck::kInput);
  CK(operand, kOpOut, out, ck::kOutput);
  CK(operand, kOpHT, h_t, ck::kOutput);
#ifdef REPRO_CHECKED
  if (threadIdx.x == 0) {   // the block's channels d .. d + nch - 1
    const long long at = static_cast<long long>(b) * T * D + d;
    const int nch = min(kThreads, D - d);
    CK(gread, kOpX, x, x + at, T, nch, D);
    CK(gread, kOpAg, a_gate, a_gate + at, T, nch, D);
    CK(gread, kOpXg, x_gate, x_gate + at, T, nch, D);
    CK(gread, kOpAParam, a_param, a_param + d, 1, nch);
    CK(gread, kOpH0, h0, h0 + static_cast<long long>(b) * D + d, 1, nch);
    CK(gwrite, kOpOut, out, out + at, T, nch, D);
    CK(gwrite, kOpHT, h_t, h_t + static_cast<long long>(b) * D + d, 1, nch);
  }
#endif
  if (d >= D) return;
  const long long row = static_cast<long long>(b) * T * D + d;
  const float ncs = neg_c_softplus(a_param[d], c);
  float h = h0[static_cast<long long>(b) * D + d];

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
    for (int s = 0; s < kSteps; ++s)
      gate(ncs, xv[s], av[s], gv[s], a[s], xb[s]);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      h = step(a[s], h, xb[s]);
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
    gate(ncs, to_f32(x[i]), to_f32(a_gate[i]), to_f32(x_gate[i]), a, xb);
    h = step(a, h, xb);
    store_as(out + i, h);
  }
  h_t[static_cast<long long>(b) * D + d] = h;
}

template <typename TX, typename TA, typename TG>
int launch(const void* x, const void* a_gate, const void* x_gate,
           const float* a_param, const float* h0, void* out, float* h_t,
           int B, int T, int D, float c, cudaStream_t stream) {
  const int d_blocks = (D + kThreads - 1) / kThreads;
  if (static_cast<long long>(d_blocks) * B > 0x7fffffff) return -1;
  CK_LAUNCH("rg_lru_simt", stream);
  rg_lru_simt<TX, TA, TG><<<d_blocks * B, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TA*>(a_gate),
      static_cast<const TG*>(x_gate), a_param, h0, static_cast<TX*>(out),
      h_t, T, D, d_blocks, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ---------------------------------------------------------------------------
// tile: TMA-fed tiles of time steps, gates by two warpgroups, a scan warp
// ---------------------------------------------------------------------------
namespace tile {

constexpr int kTileElems = 1024;    // L * Dt elements of one tile
constexpr int kStages = 3;          // input ring
constexpr int kGateStages = 2;      // (a, xb) ring
constexpr int kGateThreads = 256;   // warps 1 .. kGateThreads / 32
constexpr int kThreads = 32 + kGateThreads + 32;
constexpr int kGroups = kTileElems / (4 * kGateThreads);   // per thread
constexpr int kUnroll = 16;         // scan steps loaded ahead
constexpr int kAlign = 128;         // TMA's shared-memory alignment

template <typename TX, typename TA, typename TG>
struct Smem {
  static constexpr int kIn = kTileElems * (sizeof(TX) + sizeof(TA) +
                                           sizeof(TG));
  static constexpr int kGate = kTileElems * 8;              // float2
  static constexpr int kGateBase = kStages * kIn;
  static constexpr int kBars = kGateBase + kGateStages * kGate;
  static constexpr int kBytes =
      kBars + 8 * (2 * kStages + 2 * kGateStages) + kAlign;
};

// 4 consecutive elements of a tile in shared memory, as fp32
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
template <typename T16>
__device__ __forceinline__ void load4(const T16* p, float v[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const T16* e = reinterpret_cast<const T16*>(&q);
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = to_f32(e[j]);
}

template <typename TX, typename TA, typename TG>
__global__ void __launch_bounds__(kThreads, 4) rg_lru_tile(
    const __grid_constant__ CUtensorMap map_x,
    const __grid_constant__ CUtensorMap map_ag,
    const __grid_constant__ CUtensorMap map_xg, TX* __restrict__ out,
    const float* __restrict__ a_param, const float* __restrict__ h0,
    float* __restrict__ h_t, int T, int D, int dt, int d_tiles, float c) {
  using S = Smem<TX, TA, TG>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = ((raw + kAlign - 1) & ~(kAlign - 1)) - raw;
  uint8_t* base = smem_raw + pad;
  const uint32_t sbase = raw + pad;
  const uint32_t bars = sbase + S::kBars;
  auto in_full = [&](int s) { return bars + 8 * s; };
  auto in_empty = [&](int s) { return bars + 8 * (kStages + s); };
  auto g_full = [&](int r) { return bars + 8 * (2 * kStages + r); };
  auto g_empty = [&](int r) {
    return bars + 8 * (2 * kStages + kGateStages + r);
  };

  const int b = blockIdx.x / d_tiles;
  const int c0 = (blockIdx.x % d_tiles) * dt;
  const int L = kTileElems / dt;
  const int n_tiles = (T + L - 1) / L;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(in_full(s), 1);
      mbar_init(in_empty(s), kGateThreads);
    }
    for (int r = 0; r < kGateStages; ++r) {
      mbar_init(g_full(r), kGateThreads);
      mbar_init(g_empty(r), 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // agents: 0 the producer, 1 the gate warps (thread 32 logs), 2 the scan
  // warp (its lane 0)
  CK_BEGIN();
  CK(operand, kOpAParam, a_param, ck::kInput);
  CK(operand, kOpH0, h0, ck::kInput);
  CK(operand, kOpOut, out, ck::kOutput);
  CK(operand, kOpHT, h_t, ck::kOutput);
  CK(ring, kRingIn, kStages, ck::kMbarrier);
  CK(ring, kRingGate, kGateStages, ck::kMbarrier);

  if (warp == 0) {
    // producer: one thread keeps the input ring full
    if (lane != 0) return;
    uint64_t stream_once;   // every input byte is read once
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
                 : "=l"(stream_once));
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      mbar_wait(in_empty(s), ((i / kStages) & 1) ^ 1);
      mbar_expect_tx(in_full(s), S::kIn, CK_TAG(true, kRingIn, s, 0));
      const uint32_t dst = sbase + s * S::kIn;
      // steps past T and channels past D are TMA's zeros
      tma_3d(dst, &map_x, in_full(s), c0, i * L, b, stream_once,
             CK_BOX(true, kOpX, dt, L, 1, ck::kZeroFill));
      tma_3d(dst + kTileElems * sizeof(TX), &map_ag, in_full(s), c0, i * L,
             b, stream_once, CK_BOX(true, kOpAg, dt, L, 1, ck::kZeroFill));
      tma_3d(dst + kTileElems * (sizeof(TX) + sizeof(TA)), &map_xg,
             in_full(s), c0, i * L, b, stream_once,
             CK_BOX(true, kOpXg, dt, L, 1, ck::kZeroFill));
    }
    return;
  }

  if (warp <= kGateThreads / 32) {
    // the gate warps: element e = 4 * (g + kGateThreads * k) + j of a
    // tile is channel (4 g + j) % dt, the same for every k (dt divides 4 *
    // kGateThreads)
    const int g = threadIdx.x - 32;
    CK_IF(g == 0, gread, kOpAParam, a_param, a_param + c0, 1,
          max(0, min(dt, D - c0)));
    float ncs[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ch = c0 + (4 * g + j) % dt;
      ncs[j] = ch < D ? neg_c_softplus(a_param[ch], c) : 0.f;
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const int r = i % kGateStages;
      mbar_wait(in_full(s), (i / kStages) & 1, CK_TAG(g == 0, kRingIn, s, 1));
      CK_IF(g == 0, read, kRingIn, s, 1);
      const uint8_t* in = base + s * S::kIn;
      const TX* xs = reinterpret_cast<const TX*>(in);
      const TA* ags = reinterpret_cast<const TA*>(in + kTileElems *
                                                  sizeof(TX));
      const TG* xgs = reinterpret_cast<const TG*>(
          in + kTileElems * (sizeof(TX) + sizeof(TA)));
      // every input of the thread's kGroups x 4 elements first, so the
      // stage goes back to the producer before the math and the gates of
      // all of them are independent chains
      float xv[kGroups][4], av[kGroups][4], gv[kGroups][4];
#pragma unroll
      for (int k = 0; k < kGroups; ++k) {
        const int e = 4 * (g + kGateThreads * k);
        load4(xs + e, xv[k]);
        load4(ags + e, av[k]);
        load4(xgs + e, gv[k]);
      }
      mbar_arrive(in_empty(s), CK_TAG(g == 0, kRingIn, s, 1));
      float a[kGroups][4], xb[kGroups][4];
#pragma unroll
      for (int k = 0; k < kGroups; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          gate(ncs[j], xv[k][j], av[k][j], gv[k][j], a[k][j], xb[k][j]);
      mbar_wait(g_empty(r), ((i / kGateStages) & 1) ^ 1);
      // the gate warps fill slot r with their own stores
      CK_IF(g == 0, issue, kRingGate, r, 1);
      float4* gt = reinterpret_cast<float4*>(base + S::kGateBase +
                                             r * S::kGate);
#pragma unroll
      for (int k = 0; k < kGroups; ++k) {
        const int e = 4 * (g + kGateThreads * k);
        gt[e / 2] = make_float4(a[k][0], xb[k][0], a[k][1], xb[k][1]);
        gt[e / 2 + 1] = make_float4(a[k][2], xb[k][2], a[k][3], xb[k][3]);
      }
      mbar_arrive(g_full(r));
    }
    return;
  }

  // the scan warp: lane l carries channel c0 + l and stores its h of
  // each step straight to global memory (a warp writes dt consecutive
  // values of one step)
  const int ch = c0 + lane;
  const bool live = lane < dt && ch < D;
  const long long row = static_cast<long long>(b) * T;
  TX* o = out + row * D + ch;
  CK_IF(lane == 0, gread, kOpH0, h0, h0 + static_cast<long long>(b) * D + c0,
        1, min(dt, D - c0));
  CK_IF(lane == 0, gwrite, kOpOut, out, o, T, min(dt, D - c0), D);
  float h = live ? h0[static_cast<long long>(b) * D + ch] : 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    const int r = i % kGateStages;
    mbar_wait(g_full(r), (i / kGateStages) & 1,
              CK_TAG(lane == 0, kRingGate, r, 2));
    CK_IF(lane == 0, read, kRingGate, r, 2);
    const float2* gt = reinterpret_cast<const float2*>(base + S::kGateBase +
                                                       r * S::kGate) + lane;
    const int n = min(L, T - i * L);   // steps of T in this tile
    if (live) {
      int s0 = 0;
      for (; s0 + kUnroll <= n; s0 += kUnroll) {
        float2 v[kUnroll];
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) v[j] = gt[(s0 + j) * dt];
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
          h = step(v[j].x, h, v[j].y);
          store_stream(o + static_cast<long long>(i * L + s0 + j) * D, h);
        }
      }
      for (; s0 < n; ++s0) {
        const float2 v = gt[s0 * dt];
        h = step(v.x, h, v.y);
        store_stream(o + static_cast<long long>(i * L + s0) * D, h);
      }
    }
    mbar_arrive(g_empty(r), CK_TAG(lane == 0, kRingGate, r, 2));
  }
  CK_IF(lane == 0, gwrite, kOpHT, h_t,
        h_t + static_cast<long long>(b) * D + c0, 1, min(dt, D - c0));
  if (live) h_t[static_cast<long long>(b) * D + ch] = h;
}

template <typename T> constexpr CUtensorMapDataType map_type();
template <> constexpr CUtensorMapDataType map_type<float>() {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}
template <> constexpr CUtensorMapDataType map_type<__nv_bfloat16>() {
  return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}
template <> constexpr CUtensorMapDataType map_type<__half>() {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
}

// A (B, T, D) tensor map with boxes of dt channels x L steps x 1 row, no
// swizzle, zeros out of bounds.  L2 promotion of 256 bytes for a box row
// narrower than a 128-byte line, whose other bytes the neighbouring
// blocks read at about the same time; none for a full line, where it
// only fetched a neighbour's line a second time (measured:
// scripts/rg_lru_ablation.py).
template <typename T>
bool encode(CUtensorMap* map, const void* ptr, int B, int Tn, int D, int dt) {
  EncodeTiled fn = encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(Tn),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(D) * sizeof(T),
      static_cast<cuuint64_t>(Tn) * D * sizeof(T)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(dt),
                             static_cast<cuuint32_t>(kTileElems / dt), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapL2promotion promotion =
      dt * sizeof(T) < 128 ? CU_TENSOR_MAP_L2_PROMOTION_L2_256B
                           : CU_TENSOR_MAP_L2_PROMOTION_NONE;
  return fn(map, map_type<T>(), 3, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            promotion, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TX, typename TA, typename TG>
int launch(const void* x, const void* a_gate, const void* x_gate,
           const float* a_param, const float* h0, void* out, float* h_t,
           int B, int T, int D, float c, int dt, cudaStream_t stream) {
  // TMA: 16-byte aligned bases and row strides, boxes of 16 bytes or more
  if ((dt != 16 && dt != 32) || (D * sizeof(TX)) % 16 ||
      (D * sizeof(TA)) % 16 || (D * sizeof(TG)) % 16)
    return -1;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(a_gate) |
       reinterpret_cast<uintptr_t>(x_gate)) % 16)
    return -1;
  const int d_tiles = (D + dt - 1) / dt;
  if (static_cast<long long>(d_tiles) * B > 0x7fffffff) return -1;
  CUtensorMap mx, ma, mg;
  if (!encode<TX>(&mx, x, B, T, D, dt) || !encode<TA>(&ma, a_gate, B, T, D, dt)
      || !encode<TG>(&mg, x_gate, B, T, D, dt))
    return -2;
  using S = Smem<TX, TA, TG>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        rg_lru_tile<TX, TA, TG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        S::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  CK_MAP(kOpX, D, T, B, stream);
  CK_MAP(kOpAg, D, T, B, stream);
  CK_MAP(kOpXg, D, T, B, stream);
  CK_LAUNCH("rg_lru_tile", stream);
  rg_lru_tile<TX, TA, TG><<<d_tiles * B, kThreads, S::kBytes, stream>>>(
      mx, ma, mg, static_cast<TX*>(out), a_param, h0, h_t, T, D, dt, d_tiles,
      c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tile

struct Call {
  const void *x, *a_gate, *x_gate;
  const float *a_param, *h0;
  void* out;
  float* h_t;
  int B, T, D;
  float c;
  int path, dt;
  cudaStream_t stream;
};

template <typename TX, typename TA, typename TG>
int run(const Call& k) {
  if (k.path == 1)
    return tile::launch<TX, TA, TG>(k.x, k.a_gate, k.x_gate, k.a_param, k.h0,
                                    k.out, k.h_t, k.B, k.T, k.D, k.c, k.dt,
                                    k.stream);
  return simt::launch<TX, TA, TG>(k.x, k.a_gate, k.x_gate, k.a_param, k.h0,
                                  k.out, k.h_t, k.B, k.T, k.D, k.c, k.stream);
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

CK_NAMES("op:0:x op:1:a_gate op:2:x_gate op:3:a_param op:4:h0 op:5:out "
         "op:6:h_t ring:0:inputs ring:1:gates")

extern "C" {

// One evaluation of the gate function and nothing else: chip_smoke.py
// counts the SFU (MUFU) instructions of its SASS, up to its EXIT, as the
// SFU operations an element of the bound.  The wrapper never launches it.
__global__ void rg_lru_gate_probe(const float4* in, float2* out) {
  const float4 v = in[threadIdx.x];
  float a, xb;
  gate(v.x, v.y, v.z, v.w, a, xb);
  out[threadIdx.x] = make_float2(a, xb);
}

// x, a_gate, x_gate, out: (B, T, D) contiguous; x_dtype / a_dtype /
// g_dtype: 0 fp32, 1 bf16, 2 fp16 (out in x's); a_param (D,), h0 (B, D),
// h_t (B, D): contiguous fp32.  path: 0 "simt", 1 "tile" (dt = 16 or 32
// channels a block; every operand's rows a multiple of 16 bytes and its
// base 16-byte aligned).  Returns 0, a cudaError_t value, -1 for a call
// out of the chosen path's range, or -2 when a TMA descriptor cannot be
// made.
int rg_lru(const void* x, const void* a_gate, const void* x_gate,
           const float* a_param, const float* h0, void* out, float* h_t,
           int B, int T, int D, float c, int x_dtype, int a_dtype,
           int g_dtype, int path, int dt, void* stream) {
  if (B < 1 || T < 1 || D < 1) return -1;
  const Call k{x, a_gate, x_gate, a_param, h0, out, h_t, B, T, D, c, path,
               dt, static_cast<cudaStream_t>(stream)};
  switch (x_dtype) {
    case 0: return pick_a<float>(k, a_dtype, g_dtype);
    case 1: return pick_a<__nv_bfloat16>(k, a_dtype, g_dtype);
    case 2: return pick_a<__half>(k, a_dtype, g_dtype);
  }
  return -1;
}

const char* rg_lru_error_string(int code) {
  if (code == -1) return "shape out of the chosen path's range";
  if (code == -2) return "cuTensorMapEncodeTiled failed";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
