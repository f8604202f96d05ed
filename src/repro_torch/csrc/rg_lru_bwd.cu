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
// Two kernels; the wrapper picks one per call from the shapes
// (kernels/rg_lru.py::choose_bwd_path):
//
// 1. tile::rg_lru_bwd_tile (path "tile"; training lengths, D a multiple of
//    16 bytes of every operand's dtype), built like the forward's
//    rg_lru_tile.  One block owns one (batch row, tile of Dt channels) and
//    walks T backwards in tiles of L = kTileElems / Dt steps.  10 warps:
//    - warp 0, one thread: TMA loads (3-D tensor maps over (B, T, D), each
//      operand in its own dtype, hs in fp32; boxes of L x Dt, zeros past T
//      and D) of x, dout, a_gate, x_gate and h_{t-1} (the hs box starts one
//      step earlier; at t = 0 its row is TMA's zero fill and the gate warps
//      take h0) into a kStages ring, last tile of T first.
//    - warps 1-8, the gate warps: each thread always holds the same 4
//      consecutive channels of one step of a tile.  For tile k it reads its
//      inputs, hands the stage back, computes s, a, i in fp32 and writes
//      (a_t, dout_t) into one of two chain buffers (a = 1, dout = 0 past T,
//      so the chain passes through those steps); then, while the chain
//      warp walks tile k, it does the same for tile k + 1; then it takes
//      tile k's g from the chain buffer, forms dx, dx_gate, da_gate from
//      the values it kept in registers and streams them out, and adds its
//      da_param terms.
//    - warp 9, the chain warp (one lane a channel): walks a tile's steps
//      from last to first, g = dout + G, G = a g, the shared-memory loads
//      of the next 16 steps issued before the current 16 are walked, and
//      writes g over dout.  G carries from tile to tile; dh0 is the last G.
//    da_param: each gate thread sums its elements' terms over T (last tile
//    first); the block adds, per channel, its threads' sums in thread order
//    into a (B, D) scratch.  So dx, dx_gate, da_gate and dh0 equal the
//    simt path's bit for bit (the same element functions, the same chain);
//    da_param is the same sum taken in another order.
// 2. simt::rg_lru_bwd_simt (path "simt"; short T, and a D that TMA cannot
//    read), the first design: one block of 256 threads a (batch row, 16
//    channels), tiles of 64 steps loaded synchronously; 16 threads walk the
//    chain while the others wait; then every thread forms its elements'
//    gradients.
// Both end with rg_lru_bwd_param, which adds the (B, D) scratch over B in
// order and applies -c sigmoid(a_param).  No atomics: the same result on
// every run.  The h the chain needs is the forward's own fp32 h (the
// wrapper runs the forward with an fp32 x when gradients are recorded,
// which gives the same h bit for bit), never h recovered by inverting the
// step, which is unstable where a_t is small.  Math as the forward: expf,
// log1pf, sqrtf and true division, no fast-math; every product that feeds
// a sum is rounded on its own (__fmul_rn, __fadd_rn), so no path's result
// depends on how the compiler fuses.  A wait of more than 2^34 cycles on
// an mbarrier traps.
#include <cuda.h>          // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

// the checked build's operands and rings (check.cuh)
enum CkOp {
  kOpX = 0, kOpAg, kOpXg, kOpDout, kOpHs, kOpH0, kOpDhT, kOpAParam, kOpDx,
  kOpDag, kOpDxg, kOpDh0, kOpPart, kOpDaParam
};
// tile: the input boxes of a tile; the (a, dout) pairs the gate warps
// hand the chain warp; the g the chain warp hands back
constexpr int kRingIn = 0, kRingChain = 1, kRingGrad = 2;

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

// a_t of an element: 1 past T, so the chain passes through those steps
__device__ __forceinline__ float decay(float ncs, float sg, bool in_t) {
  return in_t ? expf(__fmul_rn(ncs, sg)) : 1.f;
}

// one step of the reverse chain: g = dout + G, then G = a g
__device__ __forceinline__ float chain(float a, float dv, float& carry) {
  const float g = __fadd_rn(dv, carry);
  carry = __fmul_rn(a, g);
  return g;
}

// an element's gradients from its g, shared by both paths
struct Grads {
  float dx, dxg, dag, das;   // das: the element's da_param term dA a s
};
__device__ __forceinline__ Grads grads(float g, float xx, float sg, float a,
                                       float ig, float hp, float ncs) {
  const float one_m = fmaf(-a, a, 1.f);
  const float beta = sqrtf(fmaxf(one_m, 1e-12f));
  const float dbeta = one_m > 1e-12f ? -a / beta : 0.f;
  const float gb = __fmul_rn(g, beta);
  const float d_a =
      fmaf(__fmul_rn(__fmul_rn(g, ig), xx), dbeta, __fmul_rn(g, hp));
  Grads r;
  r.das = __fmul_rn(__fmul_rn(d_a, a), sg);
  r.dx = __fmul_rn(gb, ig);
  r.dxg = __fmul_rn(__fmul_rn(__fmul_rn(gb, xx), ig), __fsub_rn(1.f, ig));
  r.dag = __fmul_rn(__fmul_rn(r.das, ncs), __fsub_rn(1.f, sg));
  return r;
}

// ---------------------------------------------------------------------------
// simt: tiles of 64 steps loaded by every thread, 16 threads walk the chain
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kDt = 16;                        // channels of one block
constexpr int kL = 64;                         // time steps of one tile
constexpr int kThreads = 256;
constexpr int kRowsPerPass = kThreads / kDt;   // steps a pass of the block covers
constexpr int kPer = kDt * kL / kThreads;      // elements a thread, a tile
constexpr int kChainUnroll = 16;

template <typename TX, typename TA, typename TG>
__global__ void __launch_bounds__(kThreads) rg_lru_bwd_simt(
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
  CK_BEGIN();
  CK(operand_each, kOpX, ck::kInput, x, a_gate, x_gate, dout, hs, h0, dh_t,
     a_param);
  CK(operand_each, kOpDx, ck::kOutput, dx, dag, dxg, dh0, part);
#ifdef REPRO_CHECKED
  if (tid == 0) {   // the block's channels c0 .. c0 + nch - 1, all T steps
    const int nch = min(kDt, D - c0);
    const long long at = static_cast<long long>(b) * T * D + c0;
    const long long bc = static_cast<long long>(b) * D + c0;
    CK(gread, kOpX, x, x + at, T, nch, D);
    CK(gread, kOpAg, a_gate, a_gate + at, T, nch, D);
    CK(gread, kOpXg, x_gate, x_gate + at, T, nch, D);
    CK(gread, kOpDout, dout, dout + at, T, nch, D);
    if (T > 1) CK(gread, kOpHs, hs, hs + at, T - 1, nch, D);
    CK(gread, kOpH0, h0, h0 + bc, 1, nch);
    CK(gread, kOpDhT, dh_t, dh_t + bc, 1, nch);
    CK(gread, kOpAParam, a_param, a_param + c0, 1, nch);
    CK(gwrite, kOpDx, dx, dx + at, T, nch, D);
    CK(gwrite, kOpDag, dag, dag + at, T, nch, D);
    CK(gwrite, kOpDxg, dxg, dxg + at, T, nch, D);
    CK(gwrite, kOpDh0, dh0, dh0 + bc, 1, nch);
    CK(gwrite, kOpPart, part, part + bc, 1, nch);
  }
#endif

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
      const float a = decay(ncs, sg, ok);
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
        for (int u = 0; u < kChainUnroll; ++u)
          g_s[s1 - 1 - u][tid] = chain(av_[u], dv_[u], g_c);
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
      const Grads r = grads(g_s[s][cl], xv[k], sv[k], av[k], iv[k], hp[k],
                            ncs);
      store_as(dx + i, r.dx);
      store_as(dxg + i, r.dxg);
      store_as(dag + i, r.dag);
      pacc = __fadd_rn(pacc, r.das);
    }
    __syncthreads();   // a_s and g_s are free for the next tile
  }
  if (tid < kDt && live) dh0[bd] = carry;
  // the block's per-channel sums of dA a s over T, in thread order
  red[tid] = pacc;
  __syncthreads();
  if (tid < kDt) {
    float sum = 0.f;
    for (int r = 0; r < kRowsPerPass; ++r) sum = __fadd_rn(sum, red[r * kDt + tid]);
    if (live) part[bd] = sum;
  }
}

template <typename TX, typename TA, typename TG>
int launch(const void* x, const void* a_gate, const void* x_gate,
           const void* dout, const float* hs, const float* h0,
           const float* dh_t, const float* a_param, void* dx, void* dag,
           void* dxg, float* dh0, float* part, int B, int T, int D, float c,
           cudaStream_t stream) {
  const int d_tiles = (D + kDt - 1) / kDt;
  if (static_cast<long long>(d_tiles) * B > 0x7fffffff) return -1;
  CK_LAUNCH("rg_lru_bwd_simt", stream);
  rg_lru_bwd_simt<TX, TA, TG><<<d_tiles * B, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TA*>(a_gate),
      static_cast<const TG*>(x_gate), static_cast<const TX*>(dout), hs, h0,
      dh_t, a_param, static_cast<TX*>(dx), static_cast<TA*>(dag),
      static_cast<TG*>(dxg), dh0, part, T, D, d_tiles, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ---------------------------------------------------------------------------
// tile: TMA-fed tiles walked last to first, gate warps, a chain warp
// ---------------------------------------------------------------------------
namespace tile {

constexpr int kTileElems = 1024;    // L * Dt elements of one tile
constexpr int kStages = 2;          // input ring
constexpr int kGateThreads = 256;   // warps 1 .. kGateThreads / 32
constexpr int kThreads = 32 + kGateThreads + 32;
constexpr int kUnroll = 16;         // chain steps loaded ahead
constexpr int kAlign = 128;         // TMA's shared-memory alignment
static_assert(kTileElems == 4 * kGateThreads, "one group of 4 a thread");

// a stage: x, dout (x's dtype), a_gate, x_gate, then h_{t-1} (fp32); two
// chain buffers of (a, dout -> g) float2; the per-thread da_param sums
template <typename TX, typename TA, typename TG>
struct Smem {
  static constexpr int kOffDout = kTileElems * sizeof(TX);
  static constexpr int kOffAg = 2 * kTileElems * sizeof(TX);
  static constexpr int kOffXg = kOffAg + kTileElems * sizeof(TA);
  static constexpr int kOffH = kOffXg + kTileElems * sizeof(TG);
  static constexpr int kIn = kOffH + kTileElems * 4;
  static constexpr int kChain = kTileElems * 8;
  static constexpr int kChainBase = kStages * kIn;
  static constexpr int kRed = kChainBase + 2 * kChain;
  static constexpr int kBars = kRed + kTileElems * 4;
  static constexpr int kBytes = kBars + 8 * (2 * kStages + 4) + kAlign;
};

// 4 consecutive elements in shared memory, as fp32
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
// 4 consecutive outputs as one streaming store (st.global.cs)
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
template <typename T16>
__device__ __forceinline__ void store4(T16* p, const float v[4]) {
  T16 e[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) store_as(&e[j], v[j]);
  __stcs(reinterpret_cast<uint2*>(p), *reinterpret_cast<const uint2*>(e));
}

// what a gate thread keeps of its 4 elements of a tile
struct Kept {
  float x[4], s[4], a[4], i[4], hp[4];
};

template <typename TX, typename TA, typename TG>
__global__ void __launch_bounds__(kThreads, 2) rg_lru_bwd_tile(
    const __grid_constant__ CUtensorMap map_x,
    const __grid_constant__ CUtensorMap map_do,
    const __grid_constant__ CUtensorMap map_ag,
    const __grid_constant__ CUtensorMap map_xg,
    const __grid_constant__ CUtensorMap map_h, const float* __restrict__ h0,
    const float* __restrict__ dh_t, const float* __restrict__ a_param,
    TX* __restrict__ dx, TA* __restrict__ dag, TG* __restrict__ dxg,
    float* __restrict__ dh0, float* __restrict__ part, int T, int D, int dt,
    int d_tiles, float c) {
  using S = Smem<TX, TA, TG>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = ((raw + kAlign - 1) & ~(kAlign - 1)) - raw;
  uint8_t* base = smem_raw + pad;
  const uint32_t sbase = raw + pad;
  const uint32_t bars = sbase + S::kBars;
  auto in_full = [&](int s) { return bars + 8 * s; };
  auto in_empty = [&](int s) { return bars + 8 * (kStages + s); };
  auto c_full = [&](int r) { return bars + 8 * (2 * kStages + r); };
  auto g_full = [&](int r) { return bars + 8 * (2 * kStages + 2 + r); };

  const int b = blockIdx.x / d_tiles;
  const int c0 = (blockIdx.x % d_tiles) * dt;
  const int L = kTileElems / dt;
  const int n = (T + L - 1) / L;     // tiles; walk k takes tile n - 1 - k
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(in_full(s), 1);
      mbar_init(in_empty(s), kGateThreads);
    }
    for (int r = 0; r < 2; ++r) {
      mbar_init(c_full(r), kGateThreads);
      mbar_init(g_full(r), 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // agents: 0 the producer, 1 the gate warps (thread 32 logs), 2 the chain
  // warp (its lane 0)
  CK_BEGIN();
  CK(operand_each, kOpH0, ck::kInput, h0, dh_t, a_param);
  CK(operand_each, kOpDx, ck::kOutput, dx, dag, dxg, dh0, part);
  CK(ring, kRingIn, kStages, ck::kMbarrier);
  CK(ring, kRingChain, 2, ck::kMbarrier);
  CK(ring, kRingGrad, 2, ck::kMbarrier);

  if (warp == 0) {
    // producer: one thread keeps the input ring full, last tile first
    if (lane != 0) return;
    uint64_t stream_once;   // every input byte is read once
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
                 : "=l"(stream_once));
    for (int k = 0; k < n; ++k) {
      const int s = k % kStages;
      const int t0 = (n - 1 - k) * L;
      mbar_wait(in_empty(s), ((k / kStages) & 1) ^ 1);
      mbar_expect_tx(in_full(s), S::kIn, CK_TAG(true, kRingIn, s, 0));
      const uint32_t dst = sbase + s * S::kIn;
      // steps past T and channels past D are TMA's zeros
      tma_3d(dst, &map_x, in_full(s), c0, t0, b, stream_once,
             CK_BOX(true, kOpX, dt, L, 1, ck::kZeroFill));
      tma_3d(dst + S::kOffDout, &map_do, in_full(s), c0, t0, b,
             stream_once, CK_BOX(true, kOpDout, dt, L, 1, ck::kZeroFill));
      tma_3d(dst + S::kOffAg, &map_ag, in_full(s), c0, t0, b, stream_once,
             CK_BOX(true, kOpAg, dt, L, 1, ck::kZeroFill));
      tma_3d(dst + S::kOffXg, &map_xg, in_full(s), c0, t0, b, stream_once,
             CK_BOX(true, kOpXg, dt, L, 1, ck::kZeroFill));
      // h_{t-1}: the box one step earlier (row -1 is TMA's zero fill)
      tma_3d(dst + S::kOffH, &map_h, in_full(s), c0, t0 - 1, b,
             stream_once, CK_BOX(true, kOpHs, dt, L, 1, ck::kZeroFill));
    }
    return;
  }

  if (warp <= kGateThreads / 32) {
    // the gate warps: elements 4 g .. 4 g + 3 of every tile are channels
    // (4 g) % dt .. + 3 of step 4 g / dt (dt divides 4 * kGateThreads)
    const int g = threadIdx.x - 32;
    const int e0 = 4 * g;
    const int step = e0 / dt;
    const int ch0 = c0 + e0 % dt;
    const bool live = ch0 < D;       // D % 4 == 0: all 4 or none
    float ncs[4], pacc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ncs[j] = live ? neg_c_softplus(a_param[ch0 + j], c) : 0.f;
#ifdef REPRO_CHECKED
    if (g == 0) {   // the block's channels c0 .. c0 + nch - 1, all T steps
      const int nch = min(dt, D - c0);
      const long long at = static_cast<long long>(b) * T * D + c0;
      const long long bc = static_cast<long long>(b) * D + c0;
      CK(gread, kOpAParam, a_param, a_param + c0, 1, nch);
      CK(gread, kOpH0, h0, h0 + bc, 1, nch);
      CK(gwrite, kOpDx, dx, dx + at, T, nch, D);
      CK(gwrite, kOpDag, dag, dag + at, T, nch, D);
      CK(gwrite, kOpDxg, dxg, dxg + at, T, nch, D);
      CK(gwrite, kOpPart, part, part + bc, 1, nch);
    }
#endif

    // tile k's inputs to registers, the stage back, the gates, (a, dout)
    // to chain buffer k % 2
    auto gates = [&](int k, Kept& kp) {
      const int s = k % kStages;
      mbar_wait(in_full(s), (k / kStages) & 1, CK_TAG(g == 0, kRingIn, s, 1));
      CK_IF(g == 0, read, kRingIn, s, 1);
      const uint8_t* in = base + s * S::kIn;
      float xv[4], dv[4], av[4], gv[4], hv[4];
      load4(reinterpret_cast<const TX*>(in) + e0, xv);
      load4(reinterpret_cast<const TX*>(in + S::kOffDout) + e0, dv);
      load4(reinterpret_cast<const TA*>(in + S::kOffAg) + e0, av);
      load4(reinterpret_cast<const TG*>(in + S::kOffXg) + e0, gv);
      load4(reinterpret_cast<const float*>(in + S::kOffH) + e0, hv);
      mbar_arrive(in_empty(s), CK_TAG(g == 0, kRingIn, s, 1));
      const int t = (n - 1 - k) * L + step;
      const bool in_t = live && t < T;
      // chain buffer k % 2: this thread's outputs(k - 2) read it last
      CK_IF(g == 0, issue, kRingChain, k & 1, 1);
      float2* cb = reinterpret_cast<float2*>(base + S::kChainBase +
                                             (k & 1) * S::kChain);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kp.x[j] = xv[j];
        kp.s[j] = sigmoid(av[j]);
        kp.a[j] = decay(ncs[j], kp.s[j], in_t);
        kp.i[j] = sigmoid(gv[j]);
        kp.hp[j] = t == 0 && live ? h0[static_cast<long long>(b) * D + ch0 + j]
                                  : hv[j];
      }
      float4* cb4 = reinterpret_cast<float4*>(cb + e0);
      cb4[0] = make_float4(kp.a[0], in_t ? dv[0] : 0.f, kp.a[1],
                           in_t ? dv[1] : 0.f);
      cb4[1] = make_float4(kp.a[2], in_t ? dv[2] : 0.f, kp.a[3],
                           in_t ? dv[3] : 0.f);
      mbar_arrive(c_full(k & 1));
    };
    // tile k's g from chain buffer k % 2, its gradients streamed out
    auto outputs = [&](int k, const Kept& kp) {
      mbar_wait(g_full(k & 1), (k >> 1) & 1,
                CK_TAG(g == 0, kRingGrad, k & 1, 1));
      CK_IF(g == 0, read, kRingGrad, k & 1, 1);
      const float4* cb4 = reinterpret_cast<const float4*>(
          base + S::kChainBase + (k & 1) * S::kChain) + e0 / 2;
      const float4 p0 = cb4[0], p1 = cb4[1];
      CK_IF(g == 0, release, kRingGrad, k & 1, 1);
      const float gv[4] = {p0.y, p0.w, p1.y, p1.w};
      const int t = (n - 1 - k) * L + step;
      if (!live || t >= T) return;
      float ox[4], og[4], oa[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const Grads r = grads(gv[j], kp.x[j], kp.s[j], kp.a[j], kp.i[j],
                              kp.hp[j], ncs[j]);
        ox[j] = r.dx;
        og[j] = r.dxg;
        oa[j] = r.dag;
        pacc[j] = __fadd_rn(pacc[j], r.das);
      }
      const long long i = (static_cast<long long>(b) * T + t) * D + ch0;
      store4(dx + i, ox);
      store4(dxg + i, og);
      store4(dag + i, oa);
    };
    // gates of tile k + 1 while the chain walks tile k: the two tiles'
    // kept values alternate between ka and kb
    Kept ka, kb;
    for (int k = 0; k <= n; k += 2) {
      if (k < n) gates(k, ka);
      if (k >= 1) outputs(k - 1, kb);
      if (k + 1 < n) gates(k + 1, kb);
      if (k < n) outputs(k, ka);
    }
    // the block's per-channel da_param sums, threads in order
    float* red = reinterpret_cast<float*>(base + S::kRed);
    *reinterpret_cast<float4*>(red + e0) =
        make_float4(pacc[0], pacc[1], pacc[2], pacc[3]);
    asm volatile("bar.sync 1, %0;" ::"n"(kGateThreads) : "memory");
    if (g < dt && c0 + g < D) {
      const int per = dt / 4;   // threads with the same 4 channels: g' % per
      float sum = 0.f;
      for (int m = g / 4; m < kGateThreads; m += per)
        sum = __fadd_rn(sum, red[4 * m + g % 4]);
      part[static_cast<long long>(b) * D + c0 + g] = sum;
    }
    return;
  }

  // the chain warp: lane l walks channel c0 + l, last step first
  const int ch = c0 + lane;
  const bool live = lane < dt && ch < D;
  CK_IF(lane == 0, gread, kOpDhT, dh_t,
        dh_t + static_cast<long long>(b) * D + c0, 1, min(dt, D - c0));
  CK_IF(lane == 0, gwrite, kOpDh0, dh0,
        dh0 + static_cast<long long>(b) * D + c0, 1, min(dt, D - c0));
  float carry = live ? dh_t[static_cast<long long>(b) * D + ch] : 0.f;
  for (int k = 0; k < n; ++k) {
    mbar_wait(c_full(k & 1), (k >> 1) & 1,
              CK_TAG(lane == 0, kRingChain, k & 1, 2));
    CK_IF(lane == 0, read, kRingChain, k & 1, 2);
    if (lane < dt) {
      float2* cb = reinterpret_cast<float2*>(base + S::kChainBase +
                                             (k & 1) * S::kChain) + lane;
      float2 cur[kUnroll], nxt[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) cur[u] = cb[(L - 1 - u) * dt];
      for (int s1 = L; s1 > 0; s1 -= kUnroll) {
        if (s1 > kUnroll) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            nxt[u] = cb[(s1 - kUnroll - 1 - u) * dt];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          cb[(s1 - 1 - u) * dt].y = chain(cur[u].x, cur[u].y, carry);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) cur[u] = nxt[u];
      }
    }
    __syncwarp();
    // the chain warp's turn with buffer k % 2 ends: g goes back
    CK_IF(lane == 0, release, kRingChain, k & 1, 2);
    CK_IF(lane == 0, issue, kRingGrad, k & 1, 2);
    mbar_arrive(g_full(k & 1));
  }
  if (live) dh0[static_cast<long long>(b) * D + ch] = carry;
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
// swizzle, zeros out of bounds (also before step 0); L2 promotion as the
// forward's maps (rg_lru.cu)
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
           const void* dout, const float* hs, const float* h0,
           const float* dh_t, const float* a_param, void* dx, void* dag,
           void* dxg, float* dh0, float* part, int B, int T, int D, float c,
           int dt, cudaStream_t stream) {
  // TMA: 16-byte aligned bases and row strides; the outputs' 4-element
  // stores: 8- or 16-byte aligned bases
  if ((dt != 16 && dt != 32) || (D * sizeof(TX)) % 16 ||
      (D * sizeof(TA)) % 16 || (D * sizeof(TG)) % 16 || D % 4)
    return -1;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(a_gate) |
       reinterpret_cast<uintptr_t>(x_gate) |
       reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(hs) |
       reinterpret_cast<uintptr_t>(dx) | reinterpret_cast<uintptr_t>(dag) |
       reinterpret_cast<uintptr_t>(dxg)) % 16)
    return -1;
  const int d_tiles = (D + dt - 1) / dt;
  if (static_cast<long long>(d_tiles) * B > 0x7fffffff) return -1;
  CUtensorMap mx, md, ma, mg, mh;
  if (!encode<TX>(&mx, x, B, T, D, dt) || !encode<TX>(&md, dout, B, T, D, dt) ||
      !encode<TA>(&ma, a_gate, B, T, D, dt) ||
      !encode<TG>(&mg, x_gate, B, T, D, dt) ||
      !encode<float>(&mh, hs, B, T, D, dt))
    return -2;
  using S = Smem<TX, TA, TG>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        rg_lru_bwd_tile<TX, TA, TG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  CK_MAP(kOpX, D, T, B, stream);
  CK_MAP(kOpDout, D, T, B, stream);
  CK_MAP(kOpAg, D, T, B, stream);
  CK_MAP(kOpXg, D, T, B, stream);
  CK_MAP(kOpHs, D, T, B, stream);
  CK_LAUNCH("rg_lru_bwd_tile", stream);
  rg_lru_bwd_tile<TX, TA, TG><<<d_tiles * B, kThreads, S::kBytes, stream>>>(
      mx, md, ma, mg, mh, h0, dh_t, a_param, static_cast<TX*>(dx),
      static_cast<TA*>(dag), static_cast<TG*>(dxg), dh0, part, T, D, dt,
      d_tiles, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tile

// da_param[d] = -c sigmoid(a_param[d]) sum_b part[b, d], b in order
__global__ void rg_lru_bwd_param(const float* __restrict__ part,
                                 const float* __restrict__ a_param,
                                 float* __restrict__ da_param, int B, int D,
                                 float c) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  CK_BEGIN();
  CK(operand, kOpPart, part, ck::kInput);
  CK(operand, kOpAParam, a_param, ck::kInput);
  CK(operand, kOpDaParam, da_param, ck::kOutput);
  CK_IF(threadIdx.x == 0, gread, kOpPart, part, part + d, B,
        min(static_cast<int>(blockDim.x), D - d), D);
  CK_IF(threadIdx.x == 0, gread, kOpAParam, a_param, a_param + d, 1,
        min(static_cast<int>(blockDim.x), D - d));
  CK_IF(threadIdx.x == 0, gwrite, kOpDaParam, da_param, da_param + d, 1,
        min(static_cast<int>(blockDim.x), D - d));
  if (d >= D) return;
  float sum = 0.f;
  for (int b = 0; b < B; ++b)
    sum = __fadd_rn(sum, part[static_cast<long long>(b) * D + d]);
  da_param[d] = -c * sigmoid(a_param[d]) * sum;
}

struct Call {
  const void *x, *a_gate, *x_gate, *dout;
  const float *hs, *h0, *dh_t, *a_param;
  void *dx, *dag, *dxg;
  float *da_param, *dh0, *part;
  int B, T, D;
  float c;
  int path, dt;
  cudaStream_t stream;
};

template <typename TX, typename TA, typename TG>
int run(const Call& k) {
  const int rc =
      k.path == 1
          ? tile::launch<TX, TA, TG>(k.x, k.a_gate, k.x_gate, k.dout, k.hs,
                                     k.h0, k.dh_t, k.a_param, k.dx, k.dag,
                                     k.dxg, k.dh0, k.part, k.B, k.T, k.D,
                                     k.c, k.dt, k.stream)
          : simt::launch<TX, TA, TG>(k.x, k.a_gate, k.x_gate, k.dout, k.hs,
                                     k.h0, k.dh_t, k.a_param, k.dx, k.dag,
                                     k.dxg, k.dh0, k.part, k.B, k.T, k.D,
                                     k.c, k.stream);
  if (rc != 0) return rc;
  CK_LAUNCH("rg_lru_bwd_param", k.stream);
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

CK_NAMES("op:0:x op:1:a_gate op:2:x_gate op:3:dout op:4:hs op:5:h0 "
         "op:6:dh_t op:7:a_param op:8:dx op:9:dag op:10:dxg op:11:dh0 "
         "op:12:part op:13:da_param ring:0:inputs ring:1:chain ring:2:grads")

extern "C" {

// x, a_gate, x_gate, dout, dx, da_gate, dx_gate: (B, T, D) contiguous, each
// of its input's dtype (dout and dx in x's, da_gate in a_gate's, dx_gate
// in x_gate's; codes 0 fp32, 1 bf16, 2 fp16); hs (B, T, D), h0, dh_t, dh0,
// part (B, D) and a_param, da_param (D,): contiguous fp32 (part is
// scratch).  path: 0 "simt", 1 "tile" (dt = 16 or 32 channels a block;
// every operand's rows a multiple of 16 bytes, D % 4 == 0, 16-byte aligned
// bases).  Two launches on `stream`.  Returns 0, a cudaError_t value, -1
// for a call out of the chosen path's range, or -2 when a TMA descriptor
// cannot be made.
int rg_lru_bwd(const void* x, const void* a_gate, const void* x_gate,
               const void* dout, const float* hs, const float* h0,
               const float* dh_t, const float* a_param, void* dx,
               void* da_gate, void* dx_gate, float* da_param, float* dh0,
               float* part, int B, int T, int D, float c, int x_dtype,
               int a_dtype, int g_dtype, int path, int dt, void* stream) {
  if (B < 1 || T < 1 || D < 1 || path < 0 || path > 1) return -1;
  const Call k{x,       a_gate,  x_gate,   dout, hs,  h0,   dh_t,
               a_param, dx,      da_gate,  dx_gate, da_param, dh0, part,
               B,       T,       D,        c,    path, dt,
               static_cast<cudaStream_t>(stream)};
  switch (x_dtype) {
    case 0: return pick_a<float>(k, a_dtype, g_dtype);
    case 1: return pick_a<__nv_bfloat16>(k, a_dtype, g_dtype);
    case 2: return pick_a<__half>(k, a_dtype, g_dtype);
  }
  return -1;
}

const char* rg_lru_bwd_error_string(int code) {
  if (code == -1) return "shape out of the chosen path's range";
  if (code == -2) return "cuTensorMapEncodeTiled failed";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
