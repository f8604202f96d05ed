// Backward pass of the fused attention of flash_attention.cu: causal,
// local-window and kv_len masks, the TPU kernel's dead tiles, grouped
// queries through the q_period position wrap.  Given q (BH, Tq, D), k/v
// (BH, Tk, D) (each fp32 or bf16), the forward's output O and its gradient
// dO (BH, Tq, D) in the output's dtype, and each row's softmax statistics
// (m, l) as the forward wrote them (stats, (BH, Tq) float2), it writes dq,
// dk, dv in q's, k's and v's dtypes:
//   P = exp(s - m) / max(l, 1e-30)  (s = scale q.k; -1e30 for a masked key
//       of a live TPU tile; P = 0 for a key of a dead tile)
//   delta = rowsum(dO o O),  dP = dO V^T,  dS = P o (dP - delta) on the
//   unmasked keys (0 on masked and dead ones: the forward's -1e30 does not
//   depend on q or k)
//   dV = P^T dO,  dK = scale dS^T Q,  dQ = scale dS K.
// The stacked query heads of one K/V head (q_period) all sum into that
// head's dK and dV; padded query rows (zero dO) and padded keys (masked by
// kv_len) get zero gradient.
//
// No Pallas kernel has this backward: repro takes jax.grad of its jnp
// chunked_attention (src/repro/models/layers.py) where the port's local
// blocks run flash_attention.  Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a library with the plain C interface at the bottom of this file,
// loaded from Python with ctypes (src/repro_torch/kernels/build.py).
//
// Bound.  The function is five products over the live (query, key) pairs
// (S = Q K^T, dP = dO V^T, dV, dK, dQ: 10 D operations a pair).
// RecurrentGemma-9B's local block at 1 x 4096 tokens (16 heads on one K/V
// head, D = 256, window 2048) has 1.007e8 live pairs: 0.26 TFLOP, against
// ~0.14 GB of operands (0.04 ms).  Operations bind: on the tensor cores as
// the bf16 passes of each path (chip_smoke.py's attn_bwd_bound counts
// them), on the CUDA cores (simt) at the 67 TFLOP/s fp32 peak.
//
// Every path starts with delta_kernel (one warp a row: delta and the
// row's (m, l) into one (m, l, delta, 0) record) and adds without atomics,
// in a fixed order: the same result on every run.  Two paths, which the
// wrapper picks per call (kernels/flash_attention.py::choose_bwd_path):
// "tc" (below, wgmma with a TMA ring) for head dims that are multiples of
// 16, "simt" (fp32 on the CUDA cores) for the rest.  simt, two launches
// after delta_kernel:
// 1. dkv_kernel, KV-outer: a block of 256 threads owns 32 keys of one bh,
//    their dK and dV accumulators in registers (thread t: key t / 8,
//    columns 4 (t % 8) + 32 i), and walks every 32-row tile of the stacked
//    q axis that the masks leave live for those keys (tile_live: the TPU
//    kernel's tile skipping, the q_period wrap included).  Per row tile:
//    Q and dO to fp32 shared memory, S and dP as 2 x 2 register blocks a
//    thread (rows 2 (t / 16) + {0, 1}, keys t % 16 + {0, 16}), P and dS
//    to shared memory, then dV += P^T dO, dK += dS^T Q.
// 2. dq_kernel, Q-outer: a block owns 32 rows, dQ in registers (thread t:
//    row t / 8), and walks the live 32-key tiles the same way: S, dP, dS,
//    dQ += dS K.
// Rows of shared memory are padded by 16 bytes, so a warp's float4 reads
// of 16 rows fall in distinct banks.  expf and true division, no fast-math.
#include <cuda.h>          // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "attn_tc.cuh"

namespace {

constexpr int kMaxDevices = 64;
constexpr float kMasked = -1e30f;   // repro's finite "minus infinity"
constexpr int kThreads = 256;
constexpr int kRows = 32;           // query rows of a tile
constexpr int kKeys = 32;           // keys of a tile
constexpr int kPP = kKeys + 1;      // P / dS row stride
// the checked build's operands (check.cuh); 11-15 are the tc kernel's
// tensor maps: resident 1 and 2, streamed 1 and 2, the row records
enum CkOp {
  kOpOut = 0, kOpDout, kOpStats, kOpInfo, kOpQ, kOpK, kOpV, kOpDq, kOpDk,
  kOpDv, kOpPart, kOpR1, kOpR2, kOpS1, kOpS2, kOpInfoMap
};
// tc's rings: the resident tiles (one fill), the streamed slots, the row
// records of the dK/dV pass
constexpr int kRingRes = 0, kRingSlots = 1, kRingInfo = 2;

using bf16 = __nv_bfloat16;

struct Params {
  int bh, tq, tk, d;
  float scale;
  int causal, has_window;
  long long window;
  long long offset;
  int kv_len, bq, bkv, q_period;
  int q_bf16, k_bf16, v_bf16, o_bf16;
};

// ---- masks and tiles, as flash_attention.cu classes them ------------------

__device__ __forceinline__ bool tpu_live(const Params& p, long long q_lo,
                                         long long k_lo) {
  bool live = k_lo < p.kv_len;
  if (p.causal) live = live && k_lo <= q_lo + p.bq - 1;
  if (p.has_window) live = live && k_lo + p.bkv - 1 > q_lo - p.window;
  return live;
}
__device__ __forceinline__ long long tpu_q_lo(const Params& p, int row) {
  return p.offset + (row / p.bq) * p.bq % p.q_period;
}
__device__ __forceinline__ long long q_pos(const Params& p, int row) {
  return p.offset + row % p.q_period;
}
__device__ bool tile_live(const Params& p, int r0, int r1, int k0, int k1) {
  r1 = min(r1, p.tq - 1);
  k1 = min(k1, p.tk - 1);
  if (r0 > r1 || k0 > k1) return false;
  for (int qt = r0 / p.bq; qt <= r1 / p.bq; ++qt) {
    const long long q_lo = tpu_q_lo(p, qt * p.bq);
    for (int kt = k0 / p.bkv; kt <= k1 / p.bkv; ++kt)
      if (tpu_live(p, q_lo, static_cast<long long>(kt) * p.bkv)) return true;
  }
  return false;
}
// 0: the key takes no part for the row (a dead TPU tile, a row past Tq or
// a key past Tk); 1: masked in a live tile (scores -1e30); 2: unmasked
__device__ __forceinline__ int key_class(const Params& p, int row, int key) {
  if (row >= p.tq || key >= p.tk) return 0;
  if (!tpu_live(p, tpu_q_lo(p, row), static_cast<long long>(key / p.bkv) *
                                         p.bkv))
    return 0;
  const long long pos = q_pos(p, row);
  bool ok = key < p.kv_len;
  if (p.causal) ok = ok && key <= pos;
  if (p.has_window) ok = ok && key > pos - p.window;
  return ok ? 2 : 1;
}

// ---- loads and stores ------------------------------------------------------

__device__ __forceinline__ float4 read4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 read4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ float4 read4(const void* base, long long off,
                                        int is_bf16) {
  return is_bf16 ? read4(static_cast<const bf16*>(base) + off)
                 : read4(static_cast<const float*>(base) + off);
}
__device__ __forceinline__ void store4(void* out, long long off, int is_bf16,
                                       float4 o) {
  if (is_bf16) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(o.x, o.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(o.z, o.w);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&lo);
    u.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(static_cast<bf16*>(out) + off) = u;
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + off) = o;
  }
}
__device__ __forceinline__ void fma4(float4& acc, float a, float4 b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// n rows of D values from `src` (rows first..first + n - 1 of a bh plane of
// `len` rows) into fp32 shared memory of row stride `stride`; rows past
// `len` read as zeros
__device__ __forceinline__ void load_rows(float* dst, int stride,
                                          const void* src, int is_bf16,
                                          long long plane, int first, int n,
                                          int len, int D) {
  const int c4 = D / 4;
  for (int idx = threadIdx.x; idx < n * c4; idx += kThreads) {
    const int r = idx / c4;
    const int col = (idx % c4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (first + r < len)
      v = read4(src, (plane * len + first + r) * D + col, is_bf16);
    *reinterpret_cast<float4*>(dst + r * stride + col) = v;
  }
}

template <int DMAX>
struct Smem {
  static constexpr int kStride = DMAX + 4;      // fp32 row stride
  static constexpr int kTile = kRows * kStride; // one 32-row operand tile
  // Q, dO, K, V tiles, P and dS, then m, l, delta of the 32 rows
  static constexpr size_t kBytes =
      sizeof(float) * (4 * size_t(kTile) + 2 * kRows * kPP + 3 * kRows);
};

// S and dP of the tile (rows r0.., keys k0..) from the shared Q, dO, K, V;
// P and scale * dS into shared memory.  Thread t: rows 2 (t / 16) + {0,
// 1}, keys t % 16 + {0, 16}.
template <int DMAX>
__device__ __forceinline__ void tile_p_ds(const Params& p, const float* qs,
                                          const float* dos, const float* ks,
                                          const float* vs, const float* ms,
                                          const float* ls, const float* dls,
                                          float* ps, float* dss, int r0,
                                          int k0) {
  constexpr int S = Smem<DMAX>::kStride;
  const int t = threadIdx.x;
  const int ri = 2 * (t / 16);
  const int kj = t % 16;
  float sc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  float dp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int d = 0; d < p.d; d += 4) {
    float4 qv[2], ov[2], kv[2], vv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      qv[i] = read4(qs + (ri + i) * S + d);
      ov[i] = read4(dos + (ri + i) * S + d);
      kv[i] = read4(ks + (kj + 16 * i) * S + d);
      vv[i] = read4(vs + (kj + 16 * i) * S + d);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        sc[i][j] = dot4(qv[i], kv[j], sc[i][j]);
        dp[i][j] = dot4(ov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ri + i;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kk = kj + 16 * j;
      const int cls = key_class(p, r0 + r, k0 + kk);
      float pe = 0.f, ds = 0.f;
      if (cls) {
        const float s = cls == 2 ? sc[i][j] * p.scale : kMasked;
        pe = expf(s - ms[r]) / fmaxf(ls[r], 1e-30f);
        if (cls == 2) ds = pe * (dp[i][j] - dls[r]);
      }
      ps[r * kPP + kk] = pe;
      dss[r * kPP + kk] = ds * p.scale;
    }
  }
}

// delta = rowsum(dO o O), one warp a row (lanes over 4-column chunks,
// reduced by xor shuffles: a fixed order); each row's (m, l, delta,
// 1 / max(l, 1e-30)) into info, the one per-row record both paths read
__global__ void delta_kernel(const void* __restrict__ out,
                             const void* __restrict__ dout,
                             const float2* __restrict__ stats,
                             float4* __restrict__ info, long long rows, int D,
                             int o_bf16) {
  const long long row = blockIdx.x * static_cast<long long>(kThreads / 32) +
                        threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  CK_BEGIN();
  CK(operand, kOpOut, static_cast<const unsigned char*>(out), ck::kInput);
  CK(operand, kOpDout, static_cast<const unsigned char*>(dout), ck::kInput);
  CK(operand, kOpStats, stats, ck::kInput);
  CK(operand, kOpInfo, info, ck::kOutput);
#ifdef REPRO_CHECKED
  if (threadIdx.x == 0) {   // the block's rows
    const int n = static_cast<int>(
        min(static_cast<long long>(kThreads / 32), rows - row));
    CK(rows, ck::kGRead, kOpOut, out, o_bf16, 0, static_cast<int>(row), n,
       static_cast<int>(rows), D);
    CK(rows, ck::kGRead, kOpDout, dout, o_bf16, 0, static_cast<int>(row), n,
       static_cast<int>(rows), D);
    CK(gread, kOpStats, stats, stats + row, 1, n);
    CK(gwrite, kOpInfo, info, info + row, 1, n);
  }
#endif
  if (row >= rows) return;
  float acc = 0.f;
  for (int col = 4 * lane; col < D; col += 128) {
    const float4 o = read4(out, row * D + col, o_bf16);
    const float4 g = read4(dout, row * D + col, o_bf16);
    acc = dot4(o, g, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const float2 st = stats[row];
    info[row] = make_float4(st.x, st.y, acc, 1.f / fmaxf(st.y, 1e-30f));
  }
}

struct Ptrs {
  const void *q, *k, *v, *dout;
  const float4* info;   // (bh, tq): m, l, delta, 1 / max(l, 1e-30)
  void *dq, *dk, *dv;
};

// the row statistics of rows r0.. of plane bh into shared memory
__device__ __forceinline__ void load_stats(const Params& p, const Ptrs& a,
                                           long long bh, int r0, float* ms,
                                           float* ls, float* dls) {
  const int t = threadIdx.x;
  if (t < kRows) {
    const int r = r0 + t;
    float4 st = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < p.tq) st = a.info[bh * p.tq + r];
    ms[t] = st.x;
    ls[t] = st.y;
    dls[t] = st.z;
  }
}

// KV-outer: dK and dV of 32 keys of one bh
template <int DMAX>
__global__ void __launch_bounds__(kThreads) dkv_kernel(const Params p,
                                                       const Ptrs a) {
  using Sm = Smem<DMAX>;
  constexpr int S = Sm::kStride, NC = DMAX / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = qs + Sm::kTile;
  float* ks = dos + Sm::kTile;
  float* vs = ks + Sm::kTile;
  float* ps = vs + Sm::kTile;
  float* dss = ps + kRows * kPP;
  float* ms = dss + kRows * kPP;
  float* ls = ms + kRows;
  float* dls = ls + kRows;

  const int n_kt = (p.tk + kKeys - 1) / kKeys;
  const long long bh = blockIdx.x / n_kt;
  const int k0 = (blockIdx.x % n_kt) * kKeys;
  const int t = threadIdx.x;
  const int kk = t / 8;
  const int cb = 4 * (t % 8);
  CK_BEGIN();
  CK(operand, kOpQ, static_cast<const unsigned char*>(a.q), ck::kInput);
  CK(operand, kOpK, static_cast<const unsigned char*>(a.k), ck::kInput);
  CK(operand, kOpV, static_cast<const unsigned char*>(a.v), ck::kInput);
  CK(operand, kOpDout, static_cast<const unsigned char*>(a.dout), ck::kInput);
  CK(operand, kOpInfo, a.info, ck::kInput);
  CK(operand, kOpDk, static_cast<const unsigned char*>(a.dk), ck::kOutput);
  CK(operand, kOpDv, static_cast<const unsigned char*>(a.dv), ck::kOutput);
  CK_IF(t == 0, rows, ck::kGRead, kOpK, a.k, p.k_bf16, bh, k0, kKeys, p.tk,
        p.d);
  CK_IF(t == 0, rows, ck::kGRead, kOpV, a.v, p.v_bf16, bh, k0, kKeys, p.tk,
        p.d);
  load_rows(ks, S, a.k, p.k_bf16, bh, k0, kKeys, p.tk, p.d);
  load_rows(vs, S, a.v, p.v_bf16, bh, k0, kKeys, p.tk, p.d);
  float4 dk[NC], dv[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    dk[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    dv[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int n_rt = (p.tq + kRows - 1) / kRows;
  for (int rt = 0; rt < n_rt; ++rt) {
    const int r0 = rt * kRows;
    if (!tile_live(p, r0, r0 + kRows - 1, k0, k0 + kKeys - 1)) continue;
    CK_IF(t == 0, rows, ck::kGRead, kOpQ, a.q, p.q_bf16, bh, r0, kRows, p.tq,
          p.d);
    CK_IF(t == 0, rows, ck::kGRead, kOpDout, a.dout, p.o_bf16, bh, r0, kRows,
          p.tq, p.d);
    CK_IF(t == 0, gread, kOpInfo, a.info, a.info + bh * p.tq + r0, 1,
          min(kRows, p.tq - r0));
    load_rows(qs, S, a.q, p.q_bf16, bh, r0, kRows, p.tq, p.d);
    load_rows(dos, S, a.dout, p.o_bf16, bh, r0, kRows, p.tq, p.d);
    load_stats(p, a, bh, r0, ms, ls, dls);
    __syncthreads();
    tile_p_ds<DMAX>(p, qs, dos, ks, vs, ms, ls, dls, ps, dss, r0, k0);
    __syncthreads();
    for (int r = 0; r < kRows; ++r) {
      const float pe = ps[r * kPP + kk];
      const float ds = dss[r * kPP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = cb + 32 * c;
        if (col < p.d) {
          fma4(dv[c], pe, read4(dos + r * S + col));
          fma4(dk[c], ds, read4(qs + r * S + col));
        }
      }
    }
    __syncthreads();   // Q, dO, P and dS are free for the next tile
  }
  CK_IF(t == 0, rows, ck::kGWrite, kOpDk, a.dk, p.k_bf16, bh, k0, kKeys, p.tk,
        p.d);
  CK_IF(t == 0, rows, ck::kGWrite, kOpDv, a.dv, p.v_bf16, bh, k0, kKeys, p.tk,
        p.d);
  const int key = k0 + kk;
  if (key >= p.tk) return;
  const long long off = (bh * p.tk + key) * p.d;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = cb + 32 * c;
    if (col < p.d) {
      store4(a.dk, off + col, p.k_bf16, dk[c]);
      store4(a.dv, off + col, p.v_bf16, dv[c]);
    }
  }
}

// Q-outer: dQ of 32 stacked rows of one bh
template <int DMAX>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Params p,
                                                      const Ptrs a) {
  using Sm = Smem<DMAX>;
  constexpr int S = Sm::kStride, NC = DMAX / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = qs + Sm::kTile;
  float* ks = dos + Sm::kTile;
  float* vs = ks + Sm::kTile;
  float* ps = vs + Sm::kTile;
  float* dss = ps + kRows * kPP;
  float* ms = dss + kRows * kPP;
  float* ls = ms + kRows;
  float* dls = ls + kRows;

  const int n_rt = (p.tq + kRows - 1) / kRows;
  const long long bh = blockIdx.x / n_rt;
  const int r0 = (blockIdx.x % n_rt) * kRows;
  const int t = threadIdx.x;
  const int rr = t / 8;
  const int cb = 4 * (t % 8);
  CK_BEGIN();
  CK(operand, kOpQ, static_cast<const unsigned char*>(a.q), ck::kInput);
  CK(operand, kOpK, static_cast<const unsigned char*>(a.k), ck::kInput);
  CK(operand, kOpV, static_cast<const unsigned char*>(a.v), ck::kInput);
  CK(operand, kOpDout, static_cast<const unsigned char*>(a.dout), ck::kInput);
  CK(operand, kOpInfo, a.info, ck::kInput);
  CK(operand, kOpDq, static_cast<const unsigned char*>(a.dq), ck::kOutput);
  CK_IF(t == 0, rows, ck::kGRead, kOpQ, a.q, p.q_bf16, bh, r0, kRows, p.tq,
        p.d);
  CK_IF(t == 0, rows, ck::kGRead, kOpDout, a.dout, p.o_bf16, bh, r0, kRows,
        p.tq, p.d);
  CK_IF(t == 0, gread, kOpInfo, a.info, a.info + bh * p.tq + r0, 1,
        min(kRows, p.tq - r0));
  load_rows(qs, S, a.q, p.q_bf16, bh, r0, kRows, p.tq, p.d);
  load_rows(dos, S, a.dout, p.o_bf16, bh, r0, kRows, p.tq, p.d);
  load_stats(p, a, bh, r0, ms, ls, dls);
  float4 dq[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) dq[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int n_kt = (p.tk + kKeys - 1) / kKeys;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kKeys;
    if (!tile_live(p, r0, r0 + kRows - 1, k0, k0 + kKeys - 1)) continue;
    CK_IF(t == 0, rows, ck::kGRead, kOpK, a.k, p.k_bf16, bh, k0, kKeys, p.tk,
          p.d);
    CK_IF(t == 0, rows, ck::kGRead, kOpV, a.v, p.v_bf16, bh, k0, kKeys, p.tk,
          p.d);
    load_rows(ks, S, a.k, p.k_bf16, bh, k0, kKeys, p.tk, p.d);
    load_rows(vs, S, a.v, p.v_bf16, bh, k0, kKeys, p.tk, p.d);
    __syncthreads();
    tile_p_ds<DMAX>(p, qs, dos, ks, vs, ms, ls, dls, ps, dss, r0, k0);
    __syncthreads();
    for (int j = 0; j < kKeys; ++j) {
      const float ds = dss[rr * kPP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = cb + 32 * c;
        if (col < p.d) fma4(dq[c], ds, read4(ks + j * S + col));
      }
    }
    __syncthreads();   // K, V, P and dS are free for the next tile
  }
  CK_IF(t == 0, rows, ck::kGWrite, kOpDq, a.dq, p.q_bf16, bh, r0, kRows, p.tq,
        p.d);
  const int row = r0 + rr;
  if (row >= p.tq) return;
  const long long off = (bh * p.tq + row) * p.d;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = cb + 32 * c;
    if (col < p.d) store4(a.dq, off + col, p.q_bf16, dq[c]);
  }
}

// the opt-in to > 48 KB of dynamic shared memory, once per device and kernel
template <typename K>
int allow_smem(K kernel, size_t bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return -1;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    done[dev] = true;
  }
  return 0;
}

template <int DMAX>
int launch(const Params& p, const Ptrs& a, cudaStream_t stream) {
  constexpr size_t smem = Smem<DMAX>::kBytes;
  static bool set_kv[kMaxDevices] = {}, set_q[kMaxDevices] = {};
  int rc = allow_smem(dkv_kernel<DMAX>, smem, set_kv);
  if (rc) return rc;
  rc = allow_smem(dq_kernel<DMAX>, smem, set_q);
  if (rc) return rc;
  const long long kv_blocks =
      static_cast<long long>(p.bh) * ((p.tk + kKeys - 1) / kKeys);
  const long long q_blocks =
      static_cast<long long>(p.bh) * ((p.tq + kRows - 1) / kRows);
  if (kv_blocks > INT_MAX || q_blocks > INT_MAX) return -1;
  CK_LAUNCH("dkv_kernel", stream);
  dkv_kernel<DMAX><<<static_cast<unsigned>(kv_blocks), kThreads, smem,
                     stream>>>(p, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  CK_LAUNCH("dq_kernel", stream);
  dq_kernel<DMAX><<<static_cast<unsigned>(q_blocks), kThreads, smem,
                    stream>>>(p, a);
  return static_cast<int>(cudaGetLastError());
}


// ---- "tc": the five products on wgmma, fed by a TMA ring ------------------
//
// For calls whose head dim is a multiple of 16 (any mix of fp32 and bf16
// operands).  Two kernels of one template, bwd_tc<DMAX, PARTS, KV>:
//   KV = 1, the dK/dV pass: a block owns 64 keys of one bh (K and V stay in
//     shared memory), DH columns of dK and dV (column group `grp`) and a
//     range of the stacked row tiles (n_split ranges, so the grid fills the
//     card; each range writes an fp32 partial that reduce_kernel adds in
//     range order).  The live Q and dO row tiles (R rows) stream through
//     TMA.  Per row tile: S^T = K Q^T and dP^T = V dO^T (wgmma, both
//     operands in shared memory), P^T and dS^T in registers, then dV +=
//     P^T dO and dK += dS^T Q with P^T / dS^T as the register A operand.
//   KV = 0, the dQ pass: a block owns 64 stacked rows (Q and dO in shared
//     memory), streams the live K and V tiles (R keys), recomputes S = Q K^T
//     and dP = dO V^T, and adds dQ += dS K.  dQ needs no atomics and no dS
//     in device memory: recomputing S and dP costs 4 D of its 6 D
//     operations a pair, and the result is the same on every run.
// Operands: fp32 values are split exactly into bf16 hi + mid + lo by a
// pre-pass (split3_kernel, as the forward's tc path does; a bf16 operand
// of a mixed call is itself and two zero parts), all-bf16 calls are read
// in place (PARTS = 1).  S and dP keep the passes with part indices i + j
// <= 2 (six for fp32, one for bf16), in tc_passes order.  P and dS enter
// the other three products as NP bf16 parts of their fp32 values: three
// (exact) in fp32 calls, hi + lo in bf16 calls (relative error ~2^-17 a
// term).  With PARTS = 3 each row tile's dK / dV / dQ
// product runs in a fresh fragment that is added to the fp32 accumulator
// (a long sum kept in wgmma's accumulator misses the 1e-5 gate, found on
// moe_gemm and the forward); bf16 calls accumulate in the tensor cores.
// Shape of a block (the forward's building blocks): one producer
// warpgroup whose first thread issues every TMA load (3-D tensor maps
// over (D, T, parts x BH), 128-byte swizzle, zeros past D and T) and WGS
// consumer warpgroups: two for all-bf16 calls (setmaxnreg 40 / 232), one
// otherwise.  The consumers share the resident tile and take the live
// streamed tiles in turn, so they drift apart and one's softmax runs beside
// the other's products (two warpgroups that consumed the same tiles ran in
// lockstep and left the tensor cores idle together); each adds the other's
// sums once at the end, in a fixed order.  The resident tile and each row
// tile's (m, l, delta, 1 / l) records load once; every other load is one
// 64-column chunk of one operand (all its parts) of one streamed tile,
// through a ring of kSlots slots with full / empty mbarriers, kLoads a
// tile: both streamed operands' chunks for S and dP; where the ring holds
// four tiles' loads (kHold) the column group's chunks stay in their slots
// for the output products, else they load again.  R = 64 for bf16 calls,
// 32 with fp32 operands, so that K and V's three parts (192 KB at D = 256)
// and a two-slot ring fit 227 KB; dK/dV in column groups of 128 (dK + dV
// in 128 registers a thread), dQ over all of D.  A 384-thread block is
// compiled to 168 registers a thread whatever setmaxnreg asks for, so the
// bf16 consumers spill (chip_smoke.py's build phase prints registers and
// spills); a block without a producer warpgroup (255 registers, no spills)
// could not keep enough loads in flight and was slower, a 288-thread
// block with a producer warp launches only at 168 too, and two warpgroups
// splitting each tile by role (S, P and dV; dP, dS and dK: one accumulator
// each, no spills) were slower still, serialized by the hand-off of P
// (PERF.md section 6).
namespace tc {

constexpr int kRes = 64;          // resident rows of one consumer warpgroup
constexpr int kSmemMax = 232448;
constexpr int kMaxSlots = 24;

template <int DMAX, int PARTS, bool KV>
struct Cfg {
  static constexpr int WGS = PARTS == 1 ? 2 : 1;   // consumer warpgroups
  static constexpr int R = PARTS == 1 ? 64 : 32;   // rows of a streamed tile
  static constexpr int DHKV = 128;                 // dK/dV columns a block
  static constexpr int DHQ = 256;                  // dQ columns a block
  static constexpr int NCH = DMAX / 64;            // 64-column chunks of D
  static constexpr int DH = (KV ? DHKV : DHQ) < DMAX ? (KV ? DHKV : DHQ)
                                                     : DMAX;
  static constexpr int NCG = DH / 64;              // output chunks
  static constexpr int G = DMAX / DH;              // column groups
  static constexpr int NP = PARTS == 1 ? 2 : 3;    // parts of P and dS
  static constexpr bool FRESH = PARTS == 3;
  static constexpr int kThreads = 128 * (WGS + 1);  // and a producer
  static constexpr bool kRegs = WGS == 2;          // setmaxnreg
  static constexpr int kProducerRegs = 40, kConsumerRegs = 232;
  static constexpr int kResChunk = kRes * 128;     // 64 rows x 64 columns
  static constexpr int kResPart = NCH * kResChunk;
  static constexpr int kResOp = PARTS * kResPart;  // one operand's parts
  static constexpr int kResAll = 2 * kResOp;       // shared by the warpgroups
  static constexpr int kSlotPart = R * 128;
  static constexpr int kSlot = PARTS * kSlotPart;
  // (m, l, delta, 1 / max(l, 1e-30)) of rows: two slots of R rows (KV) or
  // the resident rows
  static constexpr int kInfo = KV ? 2 * R * 16 : kRes * 16;
  // the second warpgroup's accumulators, added by the first at the end
  // (fp32, through the ring)
  static constexpr int kSum = (KV ? 2 : 1) * NCG * 32 * 128 * 4;
  static constexpr int kBars = 8 * (1 + 2 * kMaxSlots + 4);
  static constexpr int kFit =
      (kSmemMax - 1024 - kResAll - kInfo - kBars) / kSlot;
  static constexpr int kSlots = kFit < kMaxSlots ? kFit : kMaxSlots;
  // loads of one streamed tile: both operands' chunks for S and dP; the
  // column group's chunks stay in the ring for dV and dK (KV) or dQ where
  // it holds four tiles' loads (kHold), else they load again
  static constexpr bool kHold = kSlots >= 4 * NCH;
  static constexpr int kLoads = 2 * NCH + (kHold ? 0 : (KV ? 2 : 1) * NCG);
  static constexpr int kSmem = 1024 + kResAll + kInfo + kSlots * kSlot + kBars;
  static_assert(kSlots >= 2, "ring too shallow");
  static_assert(WGS == 1 || kSlots * kSlot >= kSum, "no room for the sum");
};

// two consecutive outputs of the runtime output dtype
__device__ __forceinline__ void store2(void* out, long long off, int is_bf16,
                                       float a, float b) {
  if (is_bf16)
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + off) =
        __floats2bfloat162_rn(a, b);
  else
    *reinterpret_cast<float2*>(static_cast<float*>(out) + off) =
        make_float2(a, b);
}

// every element of the tile (rows r0..r1, keys k0..k1) is a real row and
// an unmasked key (then every TPU pair it touches is live too, see
// flash_attention.cu)
__device__ bool tile_unmasked(const Params& p, int r0, int r1, int k0,
                              int k1) {
  if (r1 >= p.tq || k1 >= p.tk || k1 >= p.kv_len) return false;
  long long pmin = p.offset, pmax = p.offset + p.q_period - 1;
  if (r0 / p.q_period == r1 / p.q_period) {
    pmin = q_pos(p, r0);
    pmax = q_pos(p, r1);
  }
  if (p.causal && k1 > pmin) return false;
  if (p.has_window && k0 <= pmax - p.window) return false;
  return true;
}

// the output product of one 64-column chunk: d (+)= A B over the passes of
// A's NP parts (registers) with B's PARTS parts (the slot at b, MN-major:
// a k16 step is 16 rows, 2 KiB, on)
template <int NP, int PARTS, int R>
__device__ __forceinline__ void out_product(float (&d)[32],
                                            const uint32_t (&a)[NP][R / 16][4],
                                            uint32_t b, int first) {
#pragma unroll
  for (int ps = 0; ps < 6; ++ps) {
    if (pass_a(ps) < NP && pass_b(ps) < PARTS) {
#pragma unroll
      for (int kk = 0; kk < R / 16; ++kk) {
        const uint64_t db =
            smem_desc(b + pass_b(ps) * R * 128 + kk * 2048, R * 128, 1024);
        wgmma_rs_n64(d, a[pass_a(ps)][kk], db,
                     first && ps == first_pass(NP, PARTS) && kk == 0 ? 0 : 1);
      }
    }
  }
}

template <int DMAX, int PARTS, bool KV>
__global__ void __launch_bounds__(Cfg<DMAX, PARTS, KV>::kThreads, 1) bwd_tc(
    const __grid_constant__ CUtensorMap map_r1,   // resident: K (KV) or Q
    const __grid_constant__ CUtensorMap map_r2,   //           V       or dO
    const __grid_constant__ CUtensorMap map_s1,   // streamed: Q       or K
    const __grid_constant__ CUtensorMap map_s2,   //           dO      or V
    const __grid_constant__ CUtensorMap map_info, const Params p,
    void* __restrict__ o1, void* __restrict__ o2, float* __restrict__ part,
    int n_split) {
  using C = Cfg<DMAX, PARTS, KV>;
  constexpr int WGS = C::WGS, R = C::R, NCH = C::NCH, NCG = C::NCG,
                NP = C::NP, kSlots = C::kSlots, kLoads = C::kLoads;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_u32 = smem_u32(smem_raw);
  const uint32_t pad = ((raw_u32 + 1023) & ~1023u) - raw_u32;
  const uint32_t base = raw_u32 + pad;   // 1 KiB for the swizzle
  const uint32_t res = base;
  const uint32_t info = res + C::kResAll;
  const uint32_t ring = info + C::kInfo;
  const uint32_t bars = ring + kSlots * C::kSlot;
  const float4* info_ptr =
      reinterpret_cast<const float4*>(smem_raw + pad + C::kResAll);
  float* sum_ptr =
      reinterpret_cast<float*>(smem_raw + pad + C::kResAll + C::kInfo);
  const uint32_t rbar = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kSlots + s); };
  auto ifull = [&](int s) { return bars + 8 * (1 + 2 * kSlots + s); };
  auto iempty = [&](int s) { return bars + 8 * (3 + 2 * kSlots + s); };

  const int t = threadIdx.x;
  if (t == 0) {
    mbar_init(rbar, 1);
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);   // the warps of the tile's warpgroup
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(ifull(s), 1);
      mbar_init(iempty(s), 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // block -> (bh, outer tile of 64, column group, split); the inner range
  const int n_out = KV ? (p.tk + kRes - 1) / kRes : (p.tq + kRes - 1) / kRes;
  const int splits = KV ? n_split : 1;
  const int split = blockIdx.x % splits;
  const int grp = blockIdx.x / splits % C::G;
  const int ot = blockIdx.x / splits / C::G % n_out;
  const int bhi = blockIdx.x / splits / C::G / n_out;
  const int o0 = ot * kRes;          // first key (KV) or row of the block
  const int n_in = KV ? (p.tq + R - 1) / R : (p.tk + R - 1) / R;
  const int per = (n_in + splits - 1) / splits;
  const int lo = split * per, hi = min(n_in, lo + per);
  auto live = [&](int j) {
    return KV ? tile_live(p, j * R, j * R + R - 1, o0, o0 + kRes - 1)
              : tile_live(p, o0, o0 + kRes - 1, j * R, j * R + R - 1);
  };
  auto next_live = [&](int j) {
    while (j < hi && !live(j)) ++j;
    return j;
  };
  CK_BEGIN();
  CK(operand, kOpPart, part, ck::kWorkspace);
  CK(operand, KV ? kOpDk : kOpDq, static_cast<const unsigned char*>(o1),
     ck::kOutput);
  CK(operand, kOpDv, static_cast<const unsigned char*>(o2), ck::kOutput);
  CK(ring, kRingRes, 1, ck::kMbarrier);
  CK(ring, kRingSlots, kSlots, ck::kMbarrier);
  CK(ring, kRingInfo, 2, ck::kMbarrier);

  if (t >= 128 * WGS) {
    // producer: its first thread loads the resident tile (and, for the dQ
    // pass, its rows' records), then, for every live inner tile in order,
    // its rows' records (KV) and its kLoads chunks (load n into slot n %
    // kSlots)
    if constexpr (C::kRegs) regs_down<C::kProducerRegs>();
    if (t != 128 * WGS) return;
    mbar_expect_tx(rbar, C::kResAll + (KV ? 0 : C::kInfo),
                   CK_TAG(true, kRingRes, 0, 0));
    // boxes past D and past the operands' rows rely on TMA's zero fill
    for (int op = 0; op < 2; ++op)
      for (int pt = 0; pt < PARTS; ++pt)
        for (int ch = 0; ch < NCH; ++ch)
          tma_3d(res + op * C::kResOp + pt * C::kResPart + ch * C::kResChunk,
                 op ? &map_r2 : &map_r1, rbar, 64 * ch, o0, bhi + pt * p.bh,
                 CK_BOX(true, op ? kOpR2 : kOpR1, 64, kRes, 1,
                        ck::kZeroFill));
    if (!KV)
      tma_3d(info, &map_info, rbar, 0, o0, bhi,
             CK_BOX(true, kOpInfoMap, 4, kRes, 1, ck::kZeroFill));
    int n = 0, it = 0;
    // tile it's loads are for consumer warpgroup it % WGS alone
    auto load = [&](const CUtensorMap* map, int ch, int j) {
      const int s = n % kSlots;
      mbar_wait(empty(s), ((n / kSlots) & 1) ^ 1);
      mbar_expect_tx(full(s), C::kSlot,
                     CK_TAG_FOR(true, kRingSlots, s, 0, it % WGS + 1));
      for (int pt = 0; pt < PARTS; ++pt)
        tma_3d(ring + s * C::kSlot + pt * C::kSlotPart, map, full(s), 64 * ch,
               j * R, bhi + pt * p.bh,
               CK_BOX(true, map == &map_s1 ? kOpS1 : kOpS2, 64, R, 1,
                      ck::kZeroFill));
      ++n;
    };
    for (int j = next_live(lo); j < hi; j = next_live(j + 1), ++it) {
      if (KV) {
        const int s = it & 1;
        mbar_wait(iempty(s), ((it >> 1) & 1) ^ 1);
        mbar_expect_tx(ifull(s), R * 16,
                       CK_TAG_FOR(true, kRingInfo, s, 0, it % WGS + 1));
        tma_3d(info + s * R * 16, &map_info, ifull(s), 0, j * R, bhi,
               CK_BOX(true, kOpInfoMap, 4, R, 1, ck::kZeroFill));
      }
      for (int ch = 0; ch < NCH; ++ch) {
        load(&map_s1, ch, j);
        load(&map_s2, ch, j);
      }
      // without kHold, the output products' chunks again: dV's dO then
      // dK's Q; dQ's K
      if (!C::kHold) {
        for (int cc = 0; cc < NCG; ++cc)
          load(KV ? &map_s2 : &map_s1, grp * NCG + cc, j);
        if (KV)
          for (int cc = 0; cc < NCG; ++cc) load(&map_s1, grp * NCG + cc, j);
      }
    }
    return;
  }

  // consumer warpgroup wg takes the live inner tiles it, it + WGS, ..., so
  // the warpgroups drift apart and one's softmax runs beside the other's
  // products.  The accumulator fragment of m64nN gives thread t rows ra
  // and ra + 8 of the resident tile and, in n8 block i, columns 8 i + 2
  // (lane % 4) + {0, 1} (register 4 i + 2 h + e: row h, column e)
  if constexpr (C::kRegs) regs_up<C::kConsumerRegs>();
  const int wg = t / 128;
  const int tw = t % 128;
  const int warp = tw / 32;
  const int lane = t % 32;
  const int ra = 16 * warp + lane / 4;
  const uint32_t r1 = res, r2 = res + C::kResOp;
  float acc1[NCG][32], acc2[NCG][32];       // KV: dV, dK; else dQ in acc2
#pragma unroll
  for (int cc = 0; cc < NCG; ++cc)
#pragma unroll
    for (int x = 0; x < 32; ++x) acc1[cc][x] = acc2[cc][x] = 0.f;
  mbar_wait(rbar, 0, CK_TAG(tw == 0, kRingRes, 0, wg + 1));
  CK_IF(tw == 0, read, kRingRes, 0, wg + 1);
  // the dQ pass: the two resident rows' records
  float4 rin[2] = {make_float4(0.f, 0.f, 0.f, 0.f),
                   make_float4(0.f, 0.f, 0.f, 0.f)};
  if (!KV) {
    rin[0] = info_ptr[ra];
    rin[1] = info_ptr[ra + 8];
  }

  int it = 0;
  for (int j = next_live(lo); j < hi; j = next_live(j + 1), ++it) {
    if (it % WGS != wg) continue;
    const int n0 = it * kLoads;        // this tile's first load
    int n = n0;
    // with kHold the column group's chunks stay for the output products:
    // S1's (Q for dK, K for dQ) and, on the dK/dV pass, S2's (dO for dV)
    auto release = [&](int m) {
      const int ch = (m - n0) / 2, op = (m - n0) % 2;
      const bool held = C::kHold && ch >= grp * NCG && ch < grp * NCG + NCG &&
                        (op == 0 || KV);
      if (!held)
        mbar_arrive(empty(m % kSlots),
                    CK_TAG(tw == 0, kRingSlots, m % kSlots, wg + 1));
    };
    // S-like X = R1 S1^T and Y = R2 S2^T over the passes, a chunk of D at
    // a time; chunk ch - 1's slots go back once its products are done
    float xs[R / 2], ys[R / 2];
    constexpr int kFirst = PARTS == 3 ? 0 : 5;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      const int s1 = n % kSlots, s2 = (n + 1) % kSlots;
      mbar_wait(full(s1), (n / kSlots) & 1,
                CK_TAG(tw == 0, kRingSlots, s1, wg + 1));
      mbar_wait(full(s2), ((n + 1) / kSlots) & 1,
                CK_TAG(tw == 0, kRingSlots, s2, wg + 1));
      CK_IF(tw == 0, read, kRingSlots, s1, wg + 1);
      CK_IF(tw == 0, read, kRingSlots, s2, wg + 1);
      n += 2;
      const uint32_t b1 = ring + s1 * C::kSlot, b2 = ring + s2 * C::kSlot;
      wgmma_fence();
#pragma unroll
      for (int ps = 0; ps < 6; ++ps) {
        if (pass_a(ps) < PARTS && pass_b(ps) < PARTS) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int acc = ps != kFirst || kk != 0 || ch != 0;
            const uint32_t ao = pass_a(ps) * C::kResPart + ch * C::kResChunk +
                                kk * 32;
            const uint32_t bo = pass_b(ps) * C::kSlotPart + kk * 32;
            wgmma_ss<R>(xs, smem_desc(r1 + ao, 16, 1024),
                        smem_desc(b1 + bo, 16, 1024), acc);
            wgmma_ss<R>(ys, smem_desc(r2 + ao, 16, 1024),
                        smem_desc(b2 + bo, 16, 1024), acc);
          }
        }
      }
      wgmma_commit();
      // with four slots or more, chunk ch - 1's go back while chunk ch's
      // products run; a shallower ring waits for each chunk
      if (kSlots < 4) {
        wgmma_wait0();
        __syncwarp();
        if (lane == 0 && ch + 1 < NCH) {
          release(n - 2);
          release(n - 1);
        }
      } else if (ch > 0) {
        wgmma_wait1();
        __syncwarp();
        if (lane == 0) {
          release(n - 4);
          release(n - 3);
        }
      }
    }
    wgmma_wait0();
#pragma unroll
    for (int x = 0; x < R / 2; ++x) {
      fence_operand(xs[x]);
      fence_operand(ys[x]);
    }
    __syncwarp();
    if (lane == 0) {
      release(n - 2);
      release(n - 1);
    }

    // P (in xs) and scale dS (in ys): KV holds them transposed (fragment
    // rows are keys, columns the tile's query rows, whose records come
    // through the info ring)
    const float4* rinfo = info_ptr;
    if (KV) {
      mbar_wait(ifull(it & 1), (it >> 1) & 1,
                CK_TAG(tw == 0, kRingInfo, it & 1, wg + 1));
      CK_IF(tw == 0, read, kRingInfo, it & 1, wg + 1);
      rinfo = info_ptr + (it & 1) * R;
    }
    const bool plain =
        KV ? tile_unmasked(p, j * R, j * R + R - 1, o0, o0 + kRes - 1)
           : tile_unmasked(p, o0, o0 + kRes - 1, j * R, j * R + R - 1);
#pragma unroll
    for (int i = 0; i < R / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * i + 2 * (lane & 3) + e;
        float4 cinf = make_float4(0.f, 0.f, 0.f, 0.f);
        if (KV) cinf = rinfo[col];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int x = 4 * i + 2 * h + e;
          const float4 ri = KV ? cinf : rin[h];
          const int row = KV ? j * R + col : o0 + ra + 8 * h;
          const int key = KV ? o0 + ra + 8 * h : j * R + col;
          const int cls = plain ? 2 : key_class(p, row, key);
          float pe = 0.f, ds = 0.f;
          if (cls) {
            const float sv = cls == 2 ? xs[x] * p.scale : kMasked;
            pe = expf(sv - ri.x) * ri.w;
            if (cls == 2) ds = pe * (ys[x] - ri.z);
          }
          xs[x] = pe;
          ys[x] = ds * p.scale;
        }
      }
    if (KV) {
      __syncwarp();
      if (lane == 0)
        mbar_arrive(iempty(it & 1), CK_TAG(tw == 0, kRingInfo, it & 1, wg + 1));
    }

    // the output products, one 64-column chunk (one slot) at a time; op:
    // the streamed operand (0: S1, 1: S2), held from the S-like loop under
    // kHold, else loaded again
    auto product = [&](float (&a32)[R / 2], float (&acc)[NCG][32], int op) {
      uint32_t pa[NP][R / 16][4];
#pragma unroll
      for (int kk = 0; kk < R / 16; ++kk)
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {
          uint32_t pr[NP];
          split_pair<NP>(a32[8 * kk + 2 * qq], a32[8 * kk + 2 * qq + 1], pr);
#pragma unroll
          for (int pt = 0; pt < NP; ++pt) pa[pt][kk][qq] = pr[pt];
        }
      // the A registers stay live until the products that read them are done
      auto keep_a = [&]() {
#pragma unroll
        for (int pt = 0; pt < NP; ++pt)
#pragma unroll
          for (int kk = 0; kk < R / 16; ++kk)
#pragma unroll
            for (int qq = 0; qq < 4; ++qq) fence_operand(pa[pt][kk][qq]);
      };
      // this chunk's slot: held from the S-like loop, or loaded again
      auto slot = [&](int cc) {
        if constexpr (C::kHold) {
          return (n0 + 2 * (grp * NCG + cc) + op) % kSlots;
        } else {
          const int s = n % kSlots;
          mbar_wait(full(s), (n / kSlots) & 1,
                    CK_TAG(tw == 0, kRingSlots, s, wg + 1));
          ++n;
          return s;
        }
      };
      // one chunk at a time: with PARTS = 3 in a fresh fragment added in
      // fp32; batching the chunks before one wait was slower (more live
      // registers, more spills)
#pragma unroll
      for (int cc = 0; cc < NCG; ++cc) {
        const int s = slot(cc);
        CK_IF(tw == 0, read, kRingSlots, s, wg + 1);
        const uint32_t b = ring + s * C::kSlot;
        float f[32];
        wgmma_fence();
        if constexpr (C::FRESH) {
          out_product<NP, PARTS, R>(f, pa, b, 1);
        } else {
          out_product<NP, PARTS, R>(acc[cc], pa, b, 0);
        }
        wgmma_commit();
        wgmma_wait0();
        keep_a();
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          if constexpr (C::FRESH) {
            fence_operand(f[x]);
            acc[cc][x] = __fadd_rn(acc[cc][x], f[x]);
          } else {
            fence_operand(acc[cc][x]);
          }
        }
        __syncwarp();
        if (lane == 0)
          mbar_arrive(empty(s), CK_TAG(tw == 0, kRingSlots, s, wg + 1));
      }
    };
    if constexpr (KV) product(xs, acc1, 1);   // dV += P^T dO
    product(ys, acc2, 0);           // dK += dS^T Q, or dQ += dS K
  }

  // two warpgroups: the second's accumulators through the (now idle) ring
  // to the first, which adds them to its own, in that order
  if constexpr (WGS == 2) {
    asm volatile("bar.sync 1, 256;" ::: "memory");   // the ring is idle
    if (wg == 1) {
#pragma unroll
      for (int cc = 0; cc < NCG; ++cc)
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          sum_ptr[(cc * 32 + x) * 128 + tw] = acc2[cc][x];
          if constexpr (KV)
            sum_ptr[((NCG + cc) * 32 + x) * 128 + tw] = acc1[cc][x];
        }
    }
    asm volatile("bar.sync 1, 256;" ::: "memory");
    if (wg == 1) return;
#pragma unroll
    for (int cc = 0; cc < NCG; ++cc)
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        acc2[cc][x] = __fadd_rn(acc2[cc][x], sum_ptr[(cc * 32 + x) * 128 + tw]);
        if constexpr (KV)
          acc1[cc][x] = __fadd_rn(acc1[cc][x],
                                  sum_ptr[((NCG + cc) * 32 + x) * 128 + tw]);
      }
  }

  // stores: KV writes dV (o2) and dK (o1) of keys o0 + ra + 8 h, or fp32
  // partials; the dQ pass writes dQ (o1) of rows o0 + ra + 8 h
  const int lim = KV ? p.tk : p.tq;
  const long long n_all = static_cast<long long>(p.bh) * lim * p.d;
#ifdef REPRO_CHECKED
  if (t == 0 && o0 < lim) {   // warpgroup 0 stores the block's tile
    const int c0 = 64 * grp * NCG;
    const int rows = min(kRes, lim - o0);
    const int cols = min(64 * NCG, p.d - c0);
    const long long at = (static_cast<long long>(bhi) * lim + o0) * p.d + c0;
    if (KV && n_split > 1) {
      const float* pk = part + 2 * n_all * split;
      CK(gwrite, kOpPart, part, pk + at, rows, cols, p.d);
      CK(gwrite, kOpPart, part, pk + n_all + at, rows, cols, p.d);
    } else {
      const int es1 = (KV ? p.k_bf16 : p.q_bf16) ? 2 : 4;
      const unsigned char* b1 = static_cast<const unsigned char*>(o1);
      CK(region, ck::kGWrite, KV ? kOpDk : kOpDq, b1, b1 + at * es1, rows,
         cols * es1, static_cast<long long>(p.d) * es1, 1, 0);
      if (KV) {
        const int es2 = p.v_bf16 ? 2 : 4;
        const unsigned char* b2 = static_cast<const unsigned char*>(o2);
        CK(region, ck::kGWrite, kOpDv, b2, b2 + at * es2, rows, cols * es2,
           static_cast<long long>(p.d) * es2, 1, 0);
      }
    }
  }
#endif
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = o0 + ra + 8 * h;
    if (r >= lim) continue;
    const long long roff = (static_cast<long long>(bhi) * lim + r) * p.d;
#pragma unroll
    for (int cc = 0; cc < NCG; ++cc)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 64 * (grp * NCG + cc) + 8 * i + 2 * (lane & 3);
        if (col >= p.d) continue;
        const int x = 4 * i + 2 * h;
        const long long off = roff + col;
        if constexpr (!KV) {
          store2(o1, off, p.q_bf16, acc2[cc][x], acc2[cc][x + 1]);
        } else if (n_split == 1) {
          store2(o1, off, p.k_bf16, acc2[cc][x], acc2[cc][x + 1]);
          store2(o2, off, p.v_bf16, acc1[cc][x], acc1[cc][x + 1]);
        } else {
          float* pk = part + 2 * n_all * split;
          *reinterpret_cast<float2*>(pk + off) =
              make_float2(acc2[cc][x], acc2[cc][x + 1]);
          *reinterpret_cast<float2*>(pk + n_all + off) =
              make_float2(acc1[cc][x], acc1[cc][x + 1]);
        }
      }
  }
}

// dk, dv = the n_split fp32 partials added in range order, in k's and v's
// dtypes
__global__ void reduce_kernel(const float* __restrict__ part,
                              void* __restrict__ dk, void* __restrict__ dv,
                              long long n, int n_split, int k_bf16,
                              int v_bf16) {
  CK_BEGIN();
  CK(operand, kOpPart, part, ck::kWorkspace);
  CK(operand, kOpDk, static_cast<const unsigned char*>(dk), ck::kOutput);
  CK(operand, kOpDv, static_cast<const unsigned char*>(dv), ck::kOutput);
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
#ifdef REPRO_CHECKED
    if (threadIdx.x == 0) {   // this step's blockDim.x values
      const int m = static_cast<int>(
          min(static_cast<long long>(blockDim.x), n - i));
      CK(gread, kOpPart, part, part + i, n_split, m, 2 * n);
      CK(gread, kOpPart, part, part + n + i, n_split, m, 2 * n);
      CK(region, ck::kGWrite, kOpDk, static_cast<const unsigned char*>(dk),
         static_cast<const unsigned char*>(dk) + i * (k_bf16 ? 2 : 4), 1,
         m * (k_bf16 ? 2 : 4), 0, 1, 0);
      CK(region, ck::kGWrite, kOpDv, static_cast<const unsigned char*>(dv),
         static_cast<const unsigned char*>(dv) + i * (v_bf16 ? 2 : 4), 1,
         m * (v_bf16 ? 2 : 4), 0, 1, 0);
    }
#endif
    float sk = 0.f, sv = 0.f;
    for (int sp = 0; sp < n_split; ++sp) {
      sk += part[2 * n * sp + i];
      sv += part[2 * n * sp + n + i];
    }
    if (k_bf16)
      static_cast<bf16*>(dk)[i] = __float2bfloat16(sk);
    else
      static_cast<float*>(dk)[i] = sk;
    if (v_bf16)
      static_cast<bf16*>(dv)[i] = __float2bfloat16(sv);
    else
      static_cast<float*>(dv)[i] = sv;
  }
}

// the (bh, tq) float4 row records as a 3-D fp32 map (4, tq, bh); boxes of
// one record x `rows` rows, no swizzle, zeros past tq
bool encode_info(CUtensorMap* map, const float4* ptr, int tq, int bh,
                 int rows) {
  EncodeTiled fn = encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[3] = {4, static_cast<cuuint64_t>(tq),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {16, static_cast<cuuint64_t>(tq) * 16};
  const cuuint32_t box[3] = {4, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
            const_cast<float4*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DMAX, int PARTS, bool KV>
int launch_pass(const CUtensorMap (&maps)[4], const float4* info,
                const Params& p, void* o1, void* o2, float* part, int n_split,
                cudaStream_t stream) {
  using C = Cfg<DMAX, PARTS, KV>;
  CUtensorMap mi;
  if (!encode_info(&mi, info, p.tq, p.bh, KV ? C::R : kRes)) return -2;
  auto kernel = bwd_tc<DMAX, PARTS, KV>;
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return -1;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev] = true;
  }
  const long long blocks = static_cast<long long>(p.bh) *
                           (((KV ? p.tk : p.tq) + kRes - 1) / kRes) * C::G *
                           (KV ? n_split : 1);
  if (blocks > INT_MAX) return -1;
  const long long planes = static_cast<long long>(PARTS) * p.bh;
  CK_MAP(kOpR1, p.d, KV ? p.tk : p.tq, planes, stream);
  CK_MAP(kOpR2, p.d, KV ? p.tk : p.tq, planes, stream);
  CK_MAP(kOpS1, p.d, KV ? p.tq : p.tk, planes, stream);
  CK_MAP(kOpS2, p.d, KV ? p.tq : p.tk, planes, stream);
  CK_MAP(kOpInfoMap, 4, p.tq, p.bh, stream);
  CK_LAUNCH(KV ? "bwd_tc<KV>" : "bwd_tc<Q>", stream);
  kernel<<<static_cast<unsigned>(blocks), C::kThreads, C::kSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], mi, p, o1, o2, part, n_split);
  return static_cast<int>(cudaGetLastError());
}

// PARTS = 1 when q, k, v and dout are all bf16 (read in place), else 3:
// the pre-pass writes each operand's three parts to `parts` once per call.
// The caller's layout (kernels/flash_attention.py::bwd_tc_layout: parts,
// parts of P and dS, consumer warpgroups, rows of a streamed tile, dK/dV
// column groups), by which it sized the grid's row ranges, must be Cfg's:
// -3 otherwise.
template <int DMAX, int PARTS>
int launch(const Params& p, const Ptrs& a, bf16* parts, float* part,
           int n_split, const int (&layout)[5], cudaStream_t stream) {
  using KVC = Cfg<DMAX, PARTS, true>;
  const int mine[5] = {PARTS, KVC::NP, KVC::WGS, KVC::R, KVC::G};
  for (int i = 0; i < 5; ++i)
    if (layout[i] != mine[i]) return -3;
  const long long nq = static_cast<long long>(p.bh) * p.tq * p.d;
  const long long nk = static_cast<long long>(p.bh) * p.tk * p.d;
  const void* src[4] = {a.q, a.k, a.v, a.dout};
  const int is_bf16[4] = {p.q_bf16, p.k_bf16, p.v_bf16, p.o_bf16};
  const long long num[4] = {nq, nk, nk, nq};
  const void* op[4];
  for (int o = 0; o < 4; ++o) {
    op[o] = src[o];
    if (PARTS == 3) {
      const int rc = split3(src[o], is_bf16[o], parts, num[o], stream);
      if (rc != 0) return rc;
      op[o] = parts;
      parts += 3 * num[o];
    }
  }
  const long long planes = static_cast<long long>(PARTS) * p.bh;
  constexpr int R = KVC::R;
  // dK/dV pass: K, V resident; Q, dO streamed
  CUtensorMap kv[4], qp[4];
  if (!encode3d(&kv[0], op[1], p.d, p.tk, planes, kRes) ||
      !encode3d(&kv[1], op[2], p.d, p.tk, planes, kRes) ||
      !encode3d(&kv[2], op[0], p.d, p.tq, planes, R) ||
      !encode3d(&kv[3], op[3], p.d, p.tq, planes, R) ||
      !encode3d(&qp[0], op[0], p.d, p.tq, planes, kRes) ||
      !encode3d(&qp[1], op[3], p.d, p.tq, planes, kRes) ||
      !encode3d(&qp[2], op[1], p.d, p.tk, planes, R) ||
      !encode3d(&qp[3], op[2], p.d, p.tk, planes, R))
    return -2;
  int rc = launch_pass<DMAX, PARTS, true>(kv, a.info, p, a.dk, a.dv, part,
                                       n_split, stream);
  if (rc != 0) return rc;
  if (n_split > 1) {
    const long long b = (nk + 255) / 256;
    CK_LAUNCH("reduce_kernel", stream);
    reduce_kernel<<<static_cast<unsigned>(b < 8192 ? b : 8192), 256, 0,
                    stream>>>(part, a.dk, a.dv, nk, n_split, p.k_bf16,
                              p.v_bf16);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return launch_pass<DMAX, PARTS, false>(qp, a.info, p, a.dq, nullptr, nullptr, 1,
                                     stream);
}

template <int PARTS>
int by_dim(const Params& p, const Ptrs& a, bf16* parts, float* part,
           int n_split, const int (&layout)[5], cudaStream_t s) {
  if (p.d <= 64)
    return launch<64, PARTS>(p, a, parts, part, n_split, layout, s);
  if (p.d <= 128)
    return launch<128, PARTS>(p, a, parts, part, n_split, layout, s);
  return launch<256, PARTS>(p, a, parts, part, n_split, layout, s);
}

}  // namespace tc

}  // namespace

CK_NAMES("op:0:out op:1:dout op:2:stats op:3:info op:4:q op:5:k op:6:v "
         "op:7:dq op:8:dk op:9:dv op:10:part op:11:resident1 "
         "op:12:resident2 op:13:streamed1 op:14:streamed2 op:15:records "
         "ring:0:resident ring:1:slots ring:2:records")

extern "C" {

// q (bh, tq, d), k/v (bh, tk, d) each fp32 (x_bf16 = 0) or bf16 (1); out,
// dout (bh, tq, d) in the output's dtype (o_bf16); stats (bh, tq) fp32
// (m, l) pairs from flash_attention's forward; info (bh, tq) float4
// scratch; dq, dk, dv in q's, k's and v's dtypes.  All contiguous and
// 16-byte aligned; d a multiple of 8 up to 256.  The masks, tiles and
// q_period are the forward call's.  path 0 = "simt" (three launches), 1 =
// "tc" (d a multiple of 16; the dK/dV pass over n_split ranges of row
// tiles, with part: fp32 scratch of 2 n_split bh tk d values when n_split
// > 1, added by a reduce launch; parts: bf16 scratch of 3 (2 bh tq d + 2
// bh tk d) values unless q, k, v and the output are all bf16, then null;
// layout: the five values of tc::launch, ignored by simt).
// Returns 0, a cudaError_t value, -1 for arguments out of range, -2 when a
// TMA descriptor cannot be made, or -3 for a tc layout that is not the
// kernel's.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* out, const void* dout, const float* stats,
                        void* info, void* dq, void* dk, void* dv,
                        int q_bf16, int k_bf16, int v_bf16, int o_bf16,
                        int bh, int tq, int tk, int d, float scale,
                        int causal, int has_window, long long window,
                        long long offset, int kv_len, int bq, int bkv,
                        int q_period, int path, int n_split,
                        const int* layout, float* part, void* parts,
                        void* stream) {
  if (bh < 1 || tq < 1 || tk < 1 || d < 8 || d > 256 || d % 8 || bq < 1 ||
      bkv < 1 || q_period < 1 || path < 0 || path > 1)
    return -1;
  const Params p{bh,     tq,     tk,     d,      scale,  causal,
                 has_window, window, offset, kv_len, bq, bkv,
                 q_period, q_bf16, k_bf16, v_bf16, o_bf16};
  auto* inf = static_cast<float4*>(info);
  const Ptrs a{q, k, v, dout, inf, dq, dk, dv};
  auto s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(bh) * tq;
  const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > INT_MAX) return -1;
  CK_LAUNCH("delta_kernel", s);
  delta_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      out, dout, reinterpret_cast<const float2*>(stats), inf, rows, d,
      o_bf16);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (path == 1) {
    const bool all_bf16 = q_bf16 && k_bf16 && v_bf16 && o_bf16;
    if (d % 16 || n_split < 1 || (n_split > 1 && !part) ||
        (!all_bf16 && !parts) || !layout)
      return -1;
    const int lay[5] = {layout[0], layout[1], layout[2], layout[3],
                        layout[4]};
    auto pb = static_cast<bf16*>(parts);
    return all_bf16 ? tc::by_dim<1>(p, a, pb, part, n_split, lay, s)
                    : tc::by_dim<3>(p, a, pb, part, n_split, lay, s);
  }
  if (d <= 64) return launch<64>(p, a, s);
  if (d <= 128) return launch<128>(p, a, s);
  return launch<256>(p, a, s);
}

const char* flash_attention_bwd_error_string(int code) {
  if (code == -1) return "arguments out of range";
  if (code == -2) return "cuTensorMapEncodeTiled failed";
  if (code == -3)
    return "the tc layout (parts, parts of P and dS, warpgroups, rows, "
           "column groups) is not the kernel's";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
