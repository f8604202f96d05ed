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
// (S = Q K^T, dP = dO V^T, dV, dK, dQ: 10 D operations a pair); this
// kernel recomputes S and dP in its second pass (14 D).  RecurrentGemma-
// 9B's local block at 1 x 4096 tokens (16 heads on one K/V head, D = 256,
// window 2048) has 1.007e8 live pairs: 0.36 TFLOP as done here, 5.4 ms at
// the 67 TFLOP/s fp32 CUDA-core peak, against ~0.14 GB of operands (0.04
// ms).  Operations bind (chip_smoke.py counts the bound at the tensor
// cores' peak, which this first kernel does not use).
//
// Design (a first, simple kernel on the CUDA cores, in fp32: no wgmma, no
// TMA).  Three launches, no atomics (the same result on every run):
// 1. delta_kernel: delta = rowsum(dO o O), one warp a row.
// 2. dkv_kernel, KV-outer: a block of 256 threads owns 32 keys of one bh,
//    their dK and dV accumulators in registers (thread t: key t / 8,
//    columns 4 (t % 8) + 32 i), and walks every 32-row tile of the stacked
//    q axis that the masks leave live for those keys (tile_live: the TPU
//    kernel's tile skipping, the q_period wrap included).  Per row tile:
//    Q and dO to fp32 shared memory, S and dP as 2 x 2 register blocks a
//    thread (rows 2 (t / 16) + {0, 1}, keys t % 16 + {0, 16}), P and dS
//    to shared memory, then dV += P^T dO, dK += dS^T Q.
// 3. dq_kernel, Q-outer: a block owns 32 rows, dQ in registers (thread t:
//    row t / 8), and walks the live 32-key tiles the same way: S, dP, dS,
//    dQ += dS K.
// Rows of shared memory are padded by 16 bytes, so a warp's float4 reads
// of 16 rows fall in distinct banks.  expf and true division, no fast-math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxDevices = 64;
constexpr float kMasked = -1e30f;   // repro's finite "minus infinity"
constexpr int kThreads = 256;
constexpr int kRows = 32;           // query rows of a tile
constexpr int kKeys = 32;           // keys of a tile
constexpr int kPP = kKeys + 1;      // P / dS row stride

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
// reduced by xor shuffles: a fixed order)
__global__ void delta_kernel(const void* __restrict__ out,
                             const void* __restrict__ dout,
                             float* __restrict__ delta, long long rows, int D,
                             int o_bf16) {
  const long long row = blockIdx.x * static_cast<long long>(kThreads / 32) +
                        threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
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
  if (lane == 0) delta[row] = acc;
}

struct Ptrs {
  const void *q, *k, *v, *dout;
  const float2* stats;
  const float* delta;
  void *dq, *dk, *dv;
};

// the row statistics of rows r0.. of plane bh into shared memory
__device__ __forceinline__ void load_stats(const Params& p, const Ptrs& a,
                                           long long bh, int r0, float* ms,
                                           float* ls, float* dls) {
  const int t = threadIdx.x;
  if (t < kRows) {
    const int r = r0 + t;
    float2 st = make_float2(0.f, 0.f);
    float dl = 0.f;
    if (r < p.tq) {
      st = a.stats[bh * p.tq + r];
      dl = a.delta[bh * p.tq + r];
    }
    ms[t] = st.x;
    ls[t] = st.y;
    dls[t] = dl;
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
  dkv_kernel<DMAX><<<static_cast<unsigned>(kv_blocks), kThreads, smem,
                     stream>>>(p, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<DMAX><<<static_cast<unsigned>(q_blocks), kThreads, smem,
                    stream>>>(p, a);
  return static_cast<int>(cudaGetLastError());
}


// ---- "tc": the five products on mma.sync (bf16 in, fp32 sums) -------------
//
// For all-bf16 calls (q, k, v and the output) with D = 64, 128 or 256.
// Tiles of 32 rows x 32 keys, 4 warps a block, operands as bf16 in shared
// memory (rows padded by 16 bytes).  S = Q K^T and dP = dO V^T are exact
// bf16 products summed in fp32 (m16n8k16); P and dS are fp32 and enter
// the other three products as two bf16 parts, hi + lo (relative error
// ~2^-17 a term).  B operands stored [k][n] are read with
// ldmatrix.trans; the rest with 32-bit shared loads.
//   dkv_tc: a block owns 32 keys and a contiguous range of the stacked
//     row tiles (n_split ranges, so the grid fills the card); warp w
//     computes S^T and dP^T for keys 16 (w / 2).. and rows 16 (w % 2)..,
//     writes P^T and dS^T parts to shared memory, then accumulates dV and
//     dK for keys 16 (w / 2).. and columns (w % 2) D / 2.. in registers.
//     With n_split > 1 each range writes an fp32 partial and reduce_kernel
//     adds them in range order.
//   dq_tc: a block owns 32 rows, warp w computes S and dP for rows
//     16 (w / 2).. and keys 16 (w % 2).., writes dS parts, then accumulates
//     dQ for rows 16 (w / 2).. and columns (w % 2) D / 2...
namespace tc {

constexpr int kThreads = 128;
constexpr int kT = 32;              // rows or keys of a tile
constexpr int kPP = kT + 8;         // P / dS part row stride (bf16)

template <int DMAX>
struct Lay {
  static constexpr int kPitch = DMAX + 8;     // bf16 operand row stride
  static constexpr int kTile = kT * kPitch;   // one 32-row operand tile
  static constexpr int kPart = kT * kPP;      // one P / dS part tile
  static constexpr size_t kBytes =
      2 * (4 * size_t(kTile) + 4 * size_t(kPart)) + 3 * kT * sizeof(float);
};

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
// four 8 x 8 bf16 matrices, transposed: lanes 0-15 address rows k0 ..
// k0 + 15 at column n0, lanes 16-31 the same rows at column n0 + 8; r0,
// r1 are the B fragment of n-tile n0, r2, r3 of n0 + 8
__device__ __forceinline__ void ldsm_x4_trans(uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3,
                                              const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(a));
}
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// v as hi + lo bf16 parts (hi = bf16(v), lo = bf16(v - hi)) of a pair
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack(__fsub_rn(v0, hf.x), __fsub_rn(v1, hf.y));
}

// 32 rows of D bf16 values (rows first.. of a bh plane of `len` rows) into
// shared memory of row stride P; rows past `len` as zeros
__device__ __forceinline__ void load_tile(bf16* dst, int P, const bf16* src,
                                          long long plane, int first,
                                          int len, int D) {
  const int c8 = D / 8;
  for (int idx = threadIdx.x; idx < kT * c8; idx += kThreads) {
    const int r = idx / c8;
    const int col = (idx % c8) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (first + r < len)
      v = *reinterpret_cast<const uint4*>(
          src + (plane * len + first + r) * D + col);
    *reinterpret_cast<uint4*>(dst + r * P + col) = v;
  }
}

// c (16 x 16: two n-tiles) = A (16 rows at a, [m][k]) . B^T (16 rows at
// b, [n][k]), both of row stride P, over k < D
__device__ __forceinline__ void mm_abt(float (&c)[2][4], const bf16* a,
                                       const bf16* b, int P, int D) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
  for (int k0 = 0; k0 < D; k0 += 16) {
    const bf16* ap = a + g * P + k0 + 2 * t;
    const uint32_t a0 = lds32(ap), a1 = lds32(ap + 8 * P),
                   a2 = lds32(ap + 8), a3 = lds32(ap + 8 * P + 8);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bf16* bp = b + (8 * j + g) * P + k0 + 2 * t;
      mma(c[j], a0, a1, a2, a3, lds32(bp), lds32(bp + 8));
    }
  }
}

// c (16 x 8 NT) += A (16 x 32 at a, [m][k], row stride kPP) . B (32 x 8 NT
// at b, [k][n], row stride P)
template <int NT>
__device__ __forceinline__ void mm_ab(float (&c)[NT][4], const bf16* a,
                                      const bf16* b, int P) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < kT; k0 += 16) {
    const bf16* ap = a + g * kPP + k0 + 2 * t;
    const uint32_t a0 = lds32(ap), a1 = lds32(ap + 8 * kPP),
                   a2 = lds32(ap + 8), a3 = lds32(ap + 8 * kPP + 8);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_trans(b0, b1, b2, b3,
                    b + (k0 + (lane & 15)) * P + 8 * j + (lane >> 4) * 8);
      mma(c[j], a0, a1, a2, a3, b0, b1);
      mma(c[j + 1], a0, a1, a2, a3, b2, b3);
    }
  }
}

// P and scale * dS of one 16 x 16 warp tile from its S and dP fragments,
// as hi / lo bf16 pairs.  Fragment element (j, e) is (m = m0 + g + 8 (e >>
// 1), n = n0 + 8 j + 2 t + (e & 1)); `rows_on_m` says whether m indexes
// query rows (dq) or keys (dkv); ms, ls, dls hold the tile's 32 rows'
// statistics at their row index within the tile.
__device__ __forceinline__ void p_ds(const Params& p, float (&s)[2][4],
                                     float (&dp)[2][4], bool rows_on_m,
                                     int r_tile, int k_tile, int m0, int n0,
                                     bool plain, const float* ms,
                                     const float* ls, const float* dls,
                                     uint32_t (&ph)[2][2], uint32_t (&pl)[2][2],
                                     uint32_t (&dh)[2][2],
                                     uint32_t (&dl)[2][2]) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float pv[2], dv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + g + 8 * hh, n = n0 + 8 * j + 2 * t + e;
        const int r = rows_on_m ? m : n, kk = rows_on_m ? n : m;
        const int cls = plain ? 2 : key_class(p, r_tile + r, k_tile + kk);
        float pe = 0.f, ds = 0.f;
        if (cls) {
          const float sv = cls == 2 ? s[j][2 * hh + e] * p.scale : kMasked;
          pe = expf(sv - ms[r]) / fmaxf(ls[r], 1e-30f);
          if (cls == 2) ds = pe * (dp[j][2 * hh + e] - dls[r]);
        }
        pv[e] = pe;
        dv[e] = ds * p.scale;
      }
      split2(pv[0], pv[1], ph[j][hh], pl[j][hh]);
      split2(dv[0], dv[1], dh[j][hh], dl[j][hh]);
    }
}

// every element of the kernel tile is a real row and an unmasked key
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
  // the TPU tiles of every pair are live too (see flash_attention.cu)
  return true;
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads) dkv_tc(const Params p,
                                                   const Ptrs a, float* part,
                                                   int n_split) {
  using L = Lay<DMAX>;
  constexpr int P = L::kPitch, NT = DMAX / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + L::kTile;
  bf16* qs = vs + L::kTile;
  bf16* dos = qs + L::kTile;
  bf16* pth = dos + L::kTile;      // P^T hi, lo; dS^T hi, lo: [key][row]
  bf16* ptl = pth + L::kPart;
  bf16* dth = ptl + L::kPart;
  bf16* dtl = dth + L::kPart;
  float* ms = reinterpret_cast<float*>(dtl + L::kPart);
  float* ls = ms + kT;
  float* dls = ls + kT;

  const int n_kt = (p.tk + kT - 1) / kT;
  const int n_rt = (p.tq + kT - 1) / kT;
  const int split = blockIdx.x % n_split;
  const long long bh = blockIdx.x / n_split / n_kt;
  const int k0 = (blockIdx.x / n_split % n_kt) * kT;
  const int per = (n_rt + n_split - 1) / n_split;
  const int rt_lo = split * per, rt_hi = min(n_rt, rt_lo + per);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int mt = w >> 1, half = w & 1;   // key tile; row / column half
  const bf16* q = static_cast<const bf16*>(a.q);
  load_tile(ks, P, static_cast<const bf16*>(a.k), bh, k0, p.tk, p.d);
  load_tile(vs, P, static_cast<const bf16*>(a.v), bh, k0, p.tk, p.d);
  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int rt = rt_lo; rt < rt_hi; ++rt) {
    const int r0 = rt * kT;
    if (!tile_live(p, r0, r0 + kT - 1, k0, k0 + kT - 1)) continue;
    load_tile(qs, P, q, bh, r0, p.tq, p.d);
    load_tile(dos, P, static_cast<const bf16*>(a.dout), bh, r0, p.tq, p.d);
    load_stats(p, a, bh, r0, ms, ls, dls);
    __syncthreads();
    // S^T and dP^T for keys 16 mt.., rows 16 half..
    float s[2][4], dp[2][4];
    mm_abt(s, ks + 16 * mt * P, qs + 16 * half * P, P, p.d);
    mm_abt(dp, vs + 16 * mt * P, dos + 16 * half * P, P, p.d);
    const bool plain = tile_unmasked(p, r0, r0 + kT - 1, k0, k0 + kT - 1);
    uint32_t ph[2][2], pl[2][2], dh[2][2], dl[2][2];
    p_ds(p, s, dp, false, r0, k0, 16 * mt, 16 * half, plain, ms, ls, dls,
         ph, pl, dh, dl);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int off = (16 * mt + g + 8 * hh) * kPP + 16 * half + 8 * j +
                        2 * t;
        *reinterpret_cast<uint32_t*>(pth + off) = ph[j][hh];
        *reinterpret_cast<uint32_t*>(ptl + off) = pl[j][hh];
        *reinterpret_cast<uint32_t*>(dth + off) = dh[j][hh];
        *reinterpret_cast<uint32_t*>(dtl + off) = dl[j][hh];
      }
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q: keys 16 mt.., columns half D / 2..
    const int c0 = half * (DMAX / 2);
    mm_ab<NT>(dv, ptl + 16 * mt * kPP, dos + c0, P);
    mm_ab<NT>(dv, pth + 16 * mt * kPP, dos + c0, P);
    mm_ab<NT>(dk, dtl + 16 * mt * kPP, qs + c0, P);
    mm_ab<NT>(dk, dth + 16 * mt * kPP, qs + c0, P);
    __syncthreads();   // Q, dO and the parts are free for the next tile
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = k0 + 16 * mt + g + 8 * hh;
      if (key >= p.tk) continue;
      const int col = half * (DMAX / 2) + 8 * j + 2 * t;
      const long long off = (bh * p.tk + key) * p.d + col;
      if (n_split == 1) {
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.dk) + off) =
            pack(dk[j][2 * hh], dk[j][2 * hh + 1]);
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.dv) + off) =
            pack(dv[j][2 * hh], dv[j][2 * hh + 1]);
      } else {
        const long long n = static_cast<long long>(p.bh) * p.tk * p.d;
        float* pk = part + 2 * n * split;
        *reinterpret_cast<float2*>(pk + off) =
            make_float2(dk[j][2 * hh], dk[j][2 * hh + 1]);
        *reinterpret_cast<float2*>(pk + n + off) =
            make_float2(dv[j][2 * hh], dv[j][2 * hh + 1]);
      }
    }
}

// dk, dv = the n_split fp32 partials added in order, to bf16
__global__ void reduce_kernel(const float* __restrict__ part,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              long long n, int n_split) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float sk = 0.f, sv = 0.f;
    for (int sp = 0; sp < n_split; ++sp) {
      sk += part[2 * n * sp + i];
      sv += part[2 * n * sp + n + i];
    }
    dk[i] = __float2bfloat16(sk);
    dv[i] = __float2bfloat16(sv);
  }
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads) dq_tc(const Params p,
                                                  const Ptrs a) {
  using L = Lay<DMAX>;
  constexpr int P = L::kPitch, NT = DMAX / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + L::kTile;
  bf16* ks = dos + L::kTile;
  bf16* vs = ks + L::kTile;
  bf16* dsh = vs + L::kTile;       // dS hi, lo: [row][key]
  bf16* dsl = dsh + L::kPart;
  float* ms = reinterpret_cast<float*>(dsl + 3 * L::kPart);
  float* ls = ms + kT;
  float* dls = ls + kT;

  const int n_rt = (p.tq + kT - 1) / kT;
  const long long bh = blockIdx.x / n_rt;
  const int r0 = (blockIdx.x % n_rt) * kT;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int mt = w >> 1, half = w & 1;   // row tile; key / column half
  load_tile(qs, P, static_cast<const bf16*>(a.q), bh, r0, p.tq, p.d);
  load_tile(dos, P, static_cast<const bf16*>(a.dout), bh, r0, p.tq, p.d);
  load_stats(p, a, bh, r0, ms, ls, dls);
  float dq[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  const int n_kt = (p.tk + kT - 1) / kT;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kT;
    if (!tile_live(p, r0, r0 + kT - 1, k0, k0 + kT - 1)) continue;
    load_tile(ks, P, static_cast<const bf16*>(a.k), bh, k0, p.tk, p.d);
    load_tile(vs, P, static_cast<const bf16*>(a.v), bh, k0, p.tk, p.d);
    __syncthreads();
    // S and dP for rows 16 mt.., keys 16 half..
    float s[2][4], dp[2][4];
    mm_abt(s, qs + 16 * mt * P, ks + 16 * half * P, P, p.d);
    mm_abt(dp, dos + 16 * mt * P, vs + 16 * half * P, P, p.d);
    const bool plain = tile_unmasked(p, r0, r0 + kT - 1, k0, k0 + kT - 1);
    uint32_t ph[2][2], pl[2][2], dh[2][2], dl[2][2];
    p_ds(p, s, dp, true, r0, k0, 16 * mt, 16 * half, plain, ms, ls, dls,
         ph, pl, dh, dl);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int off = (16 * mt + g + 8 * hh) * kPP + 16 * half + 8 * j +
                        2 * t;
        *reinterpret_cast<uint32_t*>(dsh + off) = dh[j][hh];
        *reinterpret_cast<uint32_t*>(dsl + off) = dl[j][hh];
      }
    __syncthreads();
    // dQ += dS K: rows 16 mt.., columns half D / 2..
    const int c0 = half * (DMAX / 2);
    mm_ab<NT>(dq, dsl + 16 * mt * kPP, ks + c0, P);
    mm_ab<NT>(dq, dsh + 16 * mt * kPP, ks + c0, P);
    __syncthreads();   // K, V and the parts are free for the next tile
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + 16 * mt + g + 8 * hh;
      if (row >= p.tq) continue;
      const int col = half * (DMAX / 2) + 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.dq) +
                                   (bh * p.tq + row) * p.d + col) =
          pack(dq[j][2 * hh], dq[j][2 * hh + 1]);
    }
}

template <int DMAX>
int launch(const Params& p, const Ptrs& a, float* part, int n_split,
           cudaStream_t stream) {
  constexpr size_t smem = Lay<DMAX>::kBytes;
  static bool set_kv[kMaxDevices] = {}, set_q[kMaxDevices] = {};
  int rc = allow_smem(dkv_tc<DMAX>, smem, set_kv);
  if (rc) return rc;
  rc = allow_smem(dq_tc<DMAX>, smem, set_q);
  if (rc) return rc;
  const long long kv_blocks = static_cast<long long>(p.bh) *
                              ((p.tk + kT - 1) / kT) * n_split;
  const long long q_blocks =
      static_cast<long long>(p.bh) * ((p.tq + kT - 1) / kT);
  if (kv_blocks > INT_MAX || q_blocks > INT_MAX) return -1;
  dkv_tc<DMAX><<<static_cast<unsigned>(kv_blocks), kThreads, smem,
                 stream>>>(p, a, part, n_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_split > 1) {
    const long long n = static_cast<long long>(p.bh) * p.tk * p.d;
    const long long b = (n + 255) / 256;
    reduce_kernel<<<static_cast<unsigned>(b < 8192 ? b : 8192), 256, 0,
                    stream>>>(part, static_cast<bf16*>(a.dk),
                              static_cast<bf16*>(a.dv), n, n_split);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dq_tc<DMAX><<<static_cast<unsigned>(q_blocks), kThreads, smem, stream>>>(
      p, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

extern "C" {

// q (bh, tq, d), k/v (bh, tk, d) each fp32 (x_bf16 = 0) or bf16 (1); out,
// dout (bh, tq, d) in the output's dtype (o_bf16); stats (bh, tq) fp32
// (m, l) pairs from flash_attention's forward; delta (bh, tq) fp32
// scratch; dq, dk, dv in q's, k's and v's dtypes.  All contiguous and
// 16-byte aligned; d a multiple of 8 up to 256.  The masks, tiles and
// q_period are the forward call's.  path 0 = "simt" (three launches), 1 =
// "tc" (all four operands bf16, d = 64, 128 or 256; the dK/dV pass over
// n_split ranges of row tiles, with part: fp32 scratch of 2 n_split bh tk
// d values when n_split > 1, added by a fourth launch).  Returns 0, a
// cudaError_t value, or -1 for arguments out of range.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* out, const void* dout, const float* stats,
                        float* delta, void* dq, void* dk, void* dv,
                        int q_bf16, int k_bf16, int v_bf16, int o_bf16,
                        int bh, int tq, int tk, int d, float scale,
                        int causal, int has_window, long long window,
                        long long offset, int kv_len, int bq, int bkv,
                        int q_period, int path, int n_split, float* part,
                        void* stream) {
  if (bh < 1 || tq < 1 || tk < 1 || d < 8 || d > 256 || d % 8 || bq < 1 ||
      bkv < 1 || q_period < 1)
    return -1;
  const Params p{bh,     tq,     tk,     d,      scale,  causal,
                 has_window, window, offset, kv_len, bq, bkv,
                 q_period, q_bf16, k_bf16, v_bf16, o_bf16};
  const Ptrs a{q, k, v, dout, reinterpret_cast<const float2*>(stats), delta,
               dq, dk, dv};
  auto s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(bh) * tq;
  const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > INT_MAX) return -1;
  delta_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      out, dout, delta, rows, d, o_bf16);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (path == 1) {
    if (!(q_bf16 && k_bf16 && v_bf16 && o_bf16) || n_split < 1 ||
        (n_split > 1 && !part))
      return -1;
    if (d == 64) return tc::launch<64>(p, a, part, n_split, s);
    if (d == 128) return tc::launch<128>(p, a, part, n_split, s);
    if (d == 256) return tc::launch<256>(p, a, part, n_split, s);
    return -1;
  }
  if (d <= 64) return launch<64>(p, a, s);
  if (d <= 128) return launch<128>(p, a, s);
  return launch<256>(p, a, s);
}

const char* flash_attention_bwd_error_string(int code) {
  if (code == -1) return "arguments out of range";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
