// Fused attention with an online softmax (flash attention): causal,
// local-window and kv_len masks, fully masked KV tiles skipped, grouped
// queries through the q_period position wrap.  q (BH, Tq, D), k/v (BH, Tk,
// D), each fp32 or bf16 on its own (converted on load); out (BH, Tq, D)
// fp32 or bf16.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention.  Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a library with the plain C interface at the bottom of this file,
// loaded from Python with ctypes (src/repro_torch/kernels/build.py).  The
// wrapper (src/repro_torch/kernels/flash_attention.py) picks one of three
// paths per call (choose_path there):
//
// "simt" and "splitkv" (attn_simt_kernel, fp32 FMAs on the CUDA cores).
// The TPU grid walks (bh, q tile, kv tile) with the kv axis innermost and
// keeps the running max m, denominator l and accumulator in VMEM.  Here a
// thread block owns BQ = 64 query rows (32 when Tq <= 32) of one bh and
// loops over KV tiles itself, m, l and the accumulator in registers.  4 BQ
// threads: the 16 threads of a half-warp share 4 query rows; for S = Q K^T
// a thread computes those rows against keys c, c + 16, ... of the tile (c
// = t % 16), and for P V it owns the columns 4 c .. 4 c + 3 (+ 64, + 128,
// + 192).  Row maxima and sums are reduced across the half-warp with
// shuffles; P goes through shared memory.  Q is converted to fp32 in
// shared memory once; K and V tiles move as raw bytes (each in its own
// dtype) through a two-stage cp.async ring.  The KV tile is 64 keys (32
// for D > 128 or BQ = 32), so the ring, Q and P fit the 227 KB a block may
// opt into.  The grid is (bh x q tiles, splits): bh is folded into x, so
// no 65,535 limit.  "simt" runs one split: a block walks all of Tk.
// "splitkv" is for calls whose q tiles do not fill the card (decode: 32
// bh x one q tile of 32 stacked rows at granite's widths): the KV axis is
// cut into splits of split_keys keys (a multiple of 64, so a split may end
// inside a TPU tile), one block a split.  Each block writes its fp32
// partial (m, l, acc) to scratch; the last block of a (bh, q tile) to
// finish, found through an integer counter (atomicAdd after
// __threadfence), combines all of them in split order (M = max m_s, out =
// sum acc_s e^(m_s - M) / max(sum l_s e^(m_s - M), 1e-30)) and sets the
// counter back to 0, so the counters are zeroed once.  No float atomics:
// one launch a call, the same result on every run.  A split with no live
// key for a row leaves l = 0 and acc = 0 (nothing to add); a split whose
// live keys are all masked carries m = -1e30, as the sequential walk does.
//
// "tc" (attn_tc_kernel) for prefill and the local block: Q K^T and P V on
// wgmma. fp32 operands are split exactly into bf16 hi + mid + lo (as the
// Segment SpMM's tensor-core path does) by a pre-pass (split3_kernel) that
// writes the three parts to device memory once per call; when q, k and v are
// all bf16 they are read in place (one part each), and a bf16 operand of a
// mixed call is split into itself and two zero parts. Both products keep the
// terms with part indices i + j <= 2 (six passes for fp32 x fp32: every
// dropped term is below 2^-24 of the product; one for bf16 Q K^T, three for P
// and bf16 V), smallest first, fixed at compile time. A block has one or two
// consumer warpgroups of 64 q rows each and a producer warpgroup whose first
// thread loads each consumer's Q parts once and then, for each live KV tile,
// K's parts and V's parts as separate ring slots, by TMA (3-D tensor maps
// over (D, T, parts x BH), 128-byte swizzle, zero fill past D and T). Shared
// memory is the wall: Q's three parts take 48 KB per warpgroup at D = 128 and
// 96 KB at D = 256, and a slot holds one operand's three parts of one tile
// (48 KB: 64 keys at D <= 128, 32 above). So D <= 128 runs two consumer
// warpgroups (128 rows a block sharing each slot) on two slots, D = 256 one
// on two slots. With two, setmaxnreg moves the producer's registers to the
// consumers (40 / 232; a 384-thread block is compiled to 168 a thread). S (64
// x BKV fp32) accumulates in registers; the scale, the masks (per element
// only on tiles that hold a masked or dead element), the online softmax and
// the rescale stay in fp32 registers; P is split into its three bf16 parts in
// registers, where the accumulator fragment is already wgmma's A operand (no
// trip through shared memory). P V runs per 64-column chunk of D into a fresh
// fragment that is added, in fp32, to the accumulator after its alpha rescale
// (a long sum kept in the tensor cores misses the 1e-5 gate, found on
// moe_gemm). Causal load balance: blocks take q tiles longest first (the last
// tile of each q_period group first). chip_smoke.py's build phase prints each
// variant's registers and spills (-Xptxas -v).
//
// Masks and skipping follow the TPU kernel exactly, on every path.  A KV
// tile of the TPU grid (bkv keys) is live for a TPU q tile (bq rows) when
// its first key is below kv_len, not after the q tile's last position
// (causal) and its last key is inside the window of the q tile's first
// position.  In a live TPU tile a masked key scores the finite -1e30 (as
// in repro, never -inf): a row whose live tiles hold only masked keys
// takes weight exp(0) = 1 on them, and a later live key wipes them with
// alpha = exp(-1e30 - m) = 0.  A key in a dead TPU tile, or past Tk, takes
// no part at all.  These kernels' own tiles need not match bq and bkv:
// each element is classed by the TPU tiles its row and key fall in (the
// q_period wrap and a padded Tq included), and a tile is skipped when no
// pair of TPU tiles it overlaps is live.  So only the order of summation
// differs from the TPU kernel.  The output is acc / max(l, 1e-30).  expf
// and true division, no fast-math.
//
// When gradients are recorded the wrapper passes `stats` (bh x tq float2)
// and every path writes each real row's softmax statistics there: the
// final running max m and sum l, whose log-sum-exp is m + log l (kept as
// the pair, so a row whose live keys are all masked keeps its exact 1 / l
// weights).  flash_attention_bwd.cu recomputes P = exp(s - m) / max(l,
// 1e-30) from them.  With stats null nothing else changes.
//
// Bounds.  4 D operations per live (query, key) pair: granite-3-8b
// prefill (T = 4096, 32 heads, D = 128, causal) is 137.5 GFLOP, 2.05 ms
// at the 67 TFLOP/s fp32 CUDA-core peak and 0.83 ms as six bf16 passes at
// 989 TFLOP/s; RecurrentGemma-9B's local block (T = 8192, 16 heads, D =
// 256, window 2048) 240 GFLOP, 3.59 / 1.46 ms.  Decode (4 x 1 query over
// 4096 keys) reads the K/V cache once: 134 MB fp32, 40 us; bytes bind.
#include <cuda.h>          // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "attn_tc.cuh"

namespace {

constexpr int kMaxDevices = 64;
constexpr float kMasked = -1e30f;    // repro's finite "minus infinity"
constexpr float kAbsent = -3e38f;    // a key outside every live TPU tile
constexpr int kSplitUnit = 64;       // split_keys is a multiple of this
// the checked build's operands and rings (check.cuh)
enum CkOp {
  kOpQ = 0, kOpK, kOpV, kOpOut, kOpWork, kOpCounters, kOpParts, kOpStats
};
constexpr int kRingKV = 0;   // simt / splitkv: a stage holds K's and V's tile
constexpr int kRingQ = 1;    // tc: Q's parts, loaded once
constexpr int kRingTC = 2;   // tc: a slot holds K's or V's parts of a tile

using bf16 = __nv_bfloat16;

struct Params {
  int bh, tq, tk, d;
  float scale;
  int causal, has_window;
  long long window;
  long long offset;
  int kv_len, bq, bkv, q_period;
  int q_bf16, out_bf16;
  float* stats;   // (bh, tq) x (m, l) when non-null
};

// a row's final running max and sum, for the backward pass
__device__ __forceinline__ void write_stats(const Params& p, long long bh,
                                            int row, float m, float l) {
  if (p.stats) {
    float2* st = reinterpret_cast<float2*>(p.stats);
    st[bh * p.tq + row] = make_float2(m, l);
  }
}

// ---- masks and tiles, shared by every path ---------------------------------

__device__ __forceinline__ bool tpu_live(const Params& p, long long q_lo,
                                         long long k_lo) {
  bool live = k_lo < p.kv_len;
  if (p.causal) live = live && k_lo <= q_lo + p.bq - 1;
  if (p.has_window) live = live && k_lo + p.bkv - 1 > q_lo - p.window;
  return live;
}
// first position of the TPU q tile of stacked row `row`
__device__ __forceinline__ long long tpu_q_lo(const Params& p, int row) {
  return p.offset + (row / p.bq) * p.bq % p.q_period;   // 32-bit modulo
}
__device__ __forceinline__ long long q_pos(const Params& p, int row) {
  return p.offset + row % p.q_period;
}
// a kernel tile (rows r0..r1, keys k0..k1) is live when any TPU tile pair
// it overlaps is
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
// every element of a kernel tile is a real row and an unmasked key (then
// every TPU pair it touches is live too: k_lo <= key <= pos <= the q
// tile's last position, and k_hi >= key > pos - window >= q_lo - window)
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
// the score an element takes: scaled, the finite -1e30 when masked in a
// live TPU tile, kAbsent outside every live TPU tile (or a row past Tq)
__device__ __forceinline__ float score(const Params& p, bool rvalid,
                                       long long qlo, long long qpos, int key,
                                       float s) {
  const bool in_tile =
      rvalid && key < p.tk &&
      tpu_live(p, qlo, static_cast<long long>(key / p.bkv) * p.bkv);
  bool ok = key < p.kv_len;
  if (p.causal) ok = ok && key <= qpos;
  if (p.has_window) ok = ok && key > qpos - p.window;
  return in_tile ? (ok ? s * p.scale : kMasked) : kAbsent;
}
// block L of the folded grid -> (bh, q tile of `rows` rows), longest
// first: with q tiles that divide q_period, rank r takes tile tp - 1 - r
// of every group of every bh (the causal diagonal's longest walk first)
__device__ __forceinline__ void block_tile(const Params& p, int rows,
                                           long long L, int& b, int& qt) {
  const int n_qt = (p.tq + rows - 1) / rows;
  if (p.q_period % rows == 0) {
    const int tp = p.q_period / rows;
    const long long per_rank = static_cast<long long>(p.bh) * (n_qt / tp);
    const int rank = static_cast<int>(L / per_rank);
    const long long rest = L % per_rank;
    b = static_cast<int>(rest % p.bh);
    qt = static_cast<int>(rest / p.bh) * tp + (tp - 1 - rank);
  } else {
    b = static_cast<int>(L % p.bh);
    qt = n_qt - 1 - static_cast<int>(L / p.bh);
  }
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
// o[0..3] to 4 consecutive outputs of the runtime output dtype
__device__ __forceinline__ void store4(void* out, long long off, int out_bf16,
                                       const float* o) {
  if (out_bf16) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(o[0], o[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(o[2], o[3]);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&lo);
    u.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(static_cast<bf16*>(out) + off) = u;
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + off) =
        make_float4(o[0], o[1], o[2], o[3]);
  }
}
__device__ __forceinline__ void store2(void* out, long long off, int out_bf16,
                                       float a, float b) {
  if (out_bf16) {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + off) =
        __floats2bfloat162_rn(a, b);
  } else {
    *reinterpret_cast<float2*>(static_cast<float*>(out) + off) =
        make_float2(a, b);
  }
}


__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- "simt" and "splitkv": fp32 FMAs on the CUDA cores ----------------------

template <int DMAX, int BQ>
struct Tiles {
  static constexpr int kThreads = 4 * BQ;  // 16 threads for 4 rows
  static constexpr int BKV = (DMAX > 128 || BQ < 64) ? 32 : 64;
  static constexpr int NJ = BKV / 16;      // keys a thread scores per tile
  static constexpr int NC = DMAX / 64;     // float4 column groups per thread
  static constexpr int QP = DMAX + 4;      // fp32 Q row stride (16-byte pad)
  static constexpr int PP = BKV + 4;       // fp32 P row stride
};

template <typename T, int DMAX>
__host__ __device__ constexpr int kv_stride() {   // K/V row stride, elements
  return DMAX + 16 / int(sizeof(T));
}

template <typename TK, typename TV, int DMAX, int BQ>
__host__ __device__ constexpr int stage_bytes() {  // one ring stage: K, V
  return Tiles<DMAX, BQ>::BKV *
         (kv_stride<TK, DMAX>() * int(sizeof(TK)) +
          kv_stride<TV, DMAX>() * int(sizeof(TV)));
}

template <typename TK, typename TV, int DMAX, int BQ>
constexpr size_t simt_smem() {
  using T = Tiles<DMAX, BQ>;
  return sizeof(float) * (size_t(BQ) * T::QP + size_t(BQ) * T::PP) +
         2 * size_t(stage_bytes<TK, TV, DMAX, BQ>());
}

// grid (bh x q tiles, splits); split s walks KV tiles [s tps, (s + 1) tps)
// (tps = tiles_per_split); with one split it writes the output, else a
// partial, and the last block of its (bh, q tile) combines them
template <typename TK, typename TV, int DMAX, int BQ>
__global__ void __launch_bounds__(4 * BQ) attn_simt_kernel(
    const void* __restrict__ q, const TK* __restrict__ k,
    const TV* __restrict__ v, void* __restrict__ out, float* work,
    int* counters, const Params p, int tiles_per_split) {
  using T = Tiles<DMAX, BQ>;
  constexpr int kThreads = T::kThreads, BKV = T::BKV, NJ = T::NJ,
                NC = T::NC, QP = T::QP, PP = T::PP;
  constexpr int KPK = kv_stride<TK, DMAX>(), KPV = kv_stride<TV, DMAX>();
  constexpr int EK = 16 / int(sizeof(TK)), EV = 16 / int(sizeof(TV));
  constexpr int kStage = stage_bytes<TK, TV, DMAX, BQ>();

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  float* qs = reinterpret_cast<float*>(smem);
  float* ps = qs + BQ * QP;
  unsigned char* ring = reinterpret_cast<unsigned char*>(ps + BQ * PP);

  const int t = threadIdx.x;
  const int c = t & 15;
  const int rg = t >> 4;
  const int D = p.d;
  int bhi, qt;
  block_tile(p, BQ, blockIdx.x, bhi, qt);
  const long long bh = bhi;
  const int q0 = qt * BQ;
  const int n_qt = (p.tq + BQ - 1) / BQ;
  const int n_kv = (p.tk + BKV - 1) / BKV;
  const int n_splits = gridDim.y;
  const int split = blockIdx.y;
  const int j_hi = min(n_kv, (split + 1) * tiles_per_split);
  const TK* kb = k + bh * p.tk * D;
  const TV* vb = v + bh * p.tk * D;
  CK_BEGIN();
  CK(operand, kOpQ, static_cast<const unsigned char*>(q), ck::kInput);
  CK(operand, kOpK, k, ck::kInput);
  CK(operand, kOpV, v, ck::kInput);
  CK(operand, kOpOut, static_cast<const unsigned char*>(out), ck::kOutput);
  CK(operand, kOpWork, work, ck::kWorkspace);
  CK(operand, kOpCounters, counters, ck::kCounterOp);
  CK(operand, kOpStats, p.stats, ck::kOutput);
  CK(ring, kRingKV, 2, ck::kGroups);
  CK_IF(t == 0, gread, kOpQ, static_cast<const unsigned char*>(q),
        static_cast<const unsigned char*>(q) +
            (bh * p.tq + q0) * D * (p.q_bf16 ? 2 : 4),
        1, min(BQ, p.tq - q0) * D * (p.q_bf16 ? 2 : 4));

  // Q tile to fp32 shared memory (rows past Tq read as 0)
  const long long qoff = bh * p.tq * D;
  for (int idx = t; idx < BQ * (D / 4); idx += kThreads) {
    const int r = idx / (D / 4);
    const int d4 = (idx % (D / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < p.tq) {
      const long long off = qoff + static_cast<long long>(q0 + r) * D + d4;
      val = p.q_bf16 ? read4(static_cast<const bf16*>(q) + off)
                     : read4(static_cast<const float*>(q) + off);
    }
    *reinterpret_cast<float4*>(qs + r * QP + d4) = val;
  }

  auto next_live = [&](int j) {
    while (j < j_hi &&
           !tile_live(p, q0, q0 + BQ - 1, j * BKV, j * BKV + BKV - 1))
      ++j;
    return j;
  };
  auto issue = [&](int j, int s) {
    if (j < j_hi) {
      // keys past Tk are zeros written by cp.async from 0 source bytes:
      // only the live rows are read
      CK_IF(t == 0, issue, kRingKV, s);
      CK_IF(t == 0, gread, kOpK, k, kb + static_cast<long long>(j) * BKV * D,
            1, min(BKV, p.tk - j * BKV) * D);
      CK_IF(t == 0, gread, kOpV, v, vb + static_cast<long long>(j) * BKV * D,
            1, min(BKV, p.tk - j * BKV) * D);
      TK* ks = reinterpret_cast<TK*>(ring + s * kStage);
      TV* vs = reinterpret_cast<TV*>(ring + s * kStage +
                                     BKV * KPK * int(sizeof(TK)));
      const int cpk = D / EK;               // 16-byte chunks per K row
      for (int idx = t; idx < BKV * cpk; idx += kThreads) {
        const int r = idx / cpk;
        const int e = (idx % cpk) * EK;
        const int key = j * BKV + r;
        const bool ok = key < p.tk;
        cp_async16(ks + r * KPK + e,
                   kb + (ok ? static_cast<long long>(key) * D + e : 0),
                   ok ? 16 : 0);
      }
      const int cpv = D / EV;
      for (int idx = t; idx < BKV * cpv; idx += kThreads) {
        const int r = idx / cpv;
        const int e = (idx % cpv) * EV;
        const int key = j * BKV + r;
        const bool ok = key < p.tk;
        cp_async16(vs + r * KPV + e,
                   vb + (ok ? static_cast<long long>(key) * D + e : 0),
                   ok ? 16 : 0);
      }
    }
    // empty groups keep the wait count uniform
    cp_async_commit(CK_TAG(t == 0, kRingKV, 0, 0));
  };

  // per-row state: position, TPU tile start, running max / sum
  long long qpos[4], qlo[4];
  bool rvalid[4];
  float m[4], l[4], acc[4][NC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + rg * 4 + i;
    rvalid[i] = r < p.tq;
    qpos[i] = q_pos(p, r);
    qlo[i] = tpu_q_lo(p, r);
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][cc][u] = 0.f;
  }

  int j = next_live(split * tiles_per_split);
  issue(j, 0);
  int jn = j < j_hi ? next_live(j + 1) : j_hi;
  int s = 0;
  while (j < j_hi) {
    issue(jn, s ^ 1);
    cp_async_wait<1>();   // tile j landed (this thread's copies)
    __syncthreads();      // everyone's copies and the Q tile visible
    CK_IF(t == 0, groups, kRingKV, 1);
    CK_IF(t == 0, read, kRingKV, s);
    const TK* ks = reinterpret_cast<const TK*>(ring + s * kStage);
    const TV* vs = reinterpret_cast<const TV*>(ring + s * kStage +
                                               BKV * KPK * int(sizeof(TK)));

    // S = Q K^T for rows 4 rg .. 4 rg + 3, keys c + 16 jj
    float sc[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) sc[i][jj] = 0.f;
    for (int d = 0; d < D; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = read4(qs + (rg * 4 + i) * QP + d);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float4 kv = read4(ks + (c + 16 * jj) * KPK + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float a = sc[i][jj];
          a = fmaf(qv[i].x, kv.x, a);
          a = fmaf(qv[i].y, kv.y, a);
          a = fmaf(qv[i].z, kv.z, a);
          a = fmaf(qv[i].w, kv.w, a);
          sc[i][jj] = a;
        }
      }
    }

    // masks, online softmax, P to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float sv[NJ];
      float mx = kAbsent;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        sv[jj] = score(p, rvalid[i], qlo[i], qpos[i], j * BKV + c + 16 * jj,
                       sc[i][jj]);
        mx = fmaxf(mx, sv[jj]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float ls = 0.f;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float pe = expf(sv[jj] - m_new);
        ls += pe;
        ps[(rg * 4 + i) * PP + c + 16 * jj] = pe;
      }
      ls = half_warp_sum(ls);
      l[i] = l[i] * alpha + ls;
      m[i] = m_new;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[i][cc][u] *= alpha;
    }
    __syncthreads();

    // acc += P V for the columns 4 c + 64 cc of rows 4 rg .. 4 rg + 3
    for (int kk = 0; kk < BKV; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = read4(ps + (rg * 4 + i) * PP + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const int col = 4 * c + 64 * cc;
          if (col < D) {
            const float4 vv = read4(vs + (kk + u) * KPV + col);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float pe = u == 0 ? pv[i].x
                               : u == 1 ? pv[i].y
                               : u == 2 ? pv[i].z
                                        : pv[i].w;
              acc[i][cc][0] = fmaf(pe, vv.x, acc[i][cc][0]);
              acc[i][cc][1] = fmaf(pe, vv.y, acc[i][cc][1]);
              acc[i][cc][2] = fmaf(pe, vv.z, acc[i][cc][2]);
              acc[i][cc][3] = fmaf(pe, vv.w, acc[i][cc][3]);
            }
          }
        }
      }
    }
    __syncthreads();   // stage s and P are free for the next tile
    CK_IF(t == 0, release, kRingKV, s);
    j = jn;
    jn = j < j_hi ? next_live(j + 1) : j_hi;
    s ^= 1;
  }
  cp_async_wait<0>();
  CK_IF(t == 0, groups, kRingKV, 0);

  if (n_splits == 1) {
    CK_IF(t == 0 && p.stats, gwrite, kOpStats, p.stats,
          p.stats + 2 * (bh * p.tq + q0), 1, 2 * min(BQ, p.tq - q0));
    CK_IF(t == 0, gwrite, kOpOut, static_cast<const unsigned char*>(out),
          static_cast<const unsigned char*>(out) +
              (bh * p.tq + q0) * D * (p.out_bf16 ? 2 : 4),
          1, min(BQ, p.tq - q0) * D * (p.out_bf16 ? 2 : 4));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!rvalid[i]) continue;
      if (c == 0) write_stats(p, bh, q0 + rg * 4 + i, m[i], l[i]);
      const float den = fmaxf(l[i], 1e-30f);
      const long long row = (bh * p.tq + q0 + rg * 4 + i) * D;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int col = 4 * c + 64 * cc;
        if (col < D) {
          float o[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) o[u] = acc[i][cc][u] / den;
          store4(out, row + col, p.out_bf16, o);
        }
      }
    }
    return;
  }

  // splitkv: this split's partial, [BQ][D] acc then BQ m then BQ l
  const long long ps_size = static_cast<long long>(BQ) * (D + 2);
  const long long tile = bh * n_qt + qt;
  float* part = work + (tile * n_splits + split) * ps_size;
  CK_IF(t == 0, gwrite, kOpWork, work, part, 1, static_cast<int>(ps_size));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int col = 4 * c + 64 * cc;
      if (col < D)
        *reinterpret_cast<float4*>(part + r * D + col) =
            make_float4(acc[i][cc][0], acc[i][cc][1], acc[i][cc][2],
                        acc[i][cc][3]);
    }
    if (c == 0) {
      part[BQ * D + r] = m[i];
      part[BQ * D + BQ + r] = l[i];
    }
  }
  // the last block of the (bh, q tile) to get here combines the splits
  __threadfence();
  __syncthreads();
  if (t == 0) {
    int* ctr = counters + tile;
    const int done = atomicAdd(ctr, 1);
    CK(counter, kOpCounters, tile, done, n_splits);
    last = done == n_splits - 1;
    if (last) *ctr = 0;   // ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* first = work + tile * n_splits * ps_size;
  CK_IF(t == 0, gread, kOpWork, work, first, 1,
        static_cast<int>(n_splits * ps_size));
  CK_IF(t == 0 && p.stats, gwrite, kOpStats, p.stats,
        p.stats + 2 * (bh * p.tq + q0), 1, 2 * min(BQ, p.tq - q0));
  CK_IF(t == 0, gwrite, kOpOut, static_cast<const unsigned char*>(out),
        static_cast<const unsigned char*>(out) +
            (bh * p.tq + q0) * D * (p.out_bf16 ? 2 : 4),
        1, min(BQ, p.tq - q0) * D * (p.out_bf16 ? 2 : 4));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i;
    if (!rvalid[i]) continue;
    float mx = __ldcg(first + BQ * D + r);
    for (int sp = 1; sp < n_splits; ++sp)
      mx = fmaxf(mx, __ldcg(first + sp * ps_size + BQ * D + r));
    float den = 0.f;
    float num[NC][4];
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
#pragma unroll
      for (int u = 0; u < 4; ++u) num[cc][u] = 0.f;
    for (int sp = 0; sp < n_splits; ++sp) {   // in split order
      const float* src = first + sp * ps_size;
      const float w = expf(__ldcg(src + BQ * D + r) - mx);
      den += __ldcg(src + BQ * D + BQ + r) * w;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int col = 4 * c + 64 * cc;
        if (col < D) {
          const float4 a =
              __ldcg(reinterpret_cast<const float4*>(src + r * D + col));
          num[cc][0] += a.x * w;
          num[cc][1] += a.y * w;
          num[cc][2] += a.z * w;
          num[cc][3] += a.w * w;
        }
      }
    }
    if (c == 0) write_stats(p, bh, q0 + r, mx, den);
    den = fmaxf(den, 1e-30f);
    const long long row = (bh * p.tq + q0 + r) * D;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int col = 4 * c + 64 * cc;
      if (col < D) {
        float o[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) o[u] = num[cc][u] / den;
        store4(out, row + col, p.out_bf16, o);
      }
    }
  }
}

// ---- "tc": Q K^T and P V on wgmma over the bf16 split ----------------------

namespace tc {

constexpr int kWgRows = 64;      // q rows of one consumer warpgroup
constexpr int kSmemMax = 232448;
constexpr int kMaxSlots = 6;

// WGS consumer warpgroups (64 q rows each, sharing every K/V slot) and a
// producer warpgroup: two consumers at D <= 128, one at D = 256, where Q's
// parts alone take 96 KB.  With two, the producer hands its registers to
// the consumers (setmaxnreg: 40 for it, 232 for each consumer; a 384-thread
// block is compiled to 168 a thread, which spills the consumers).
// Shared memory: each warpgroup's Q parts, then a ring of slots each
// holding one operand's (K's or V's) three parts of one KV tile; every
// part is NCH chunks of 64 columns (128-byte rows, wgmma's 128-byte
// swizzle, as TMA writes them), 1 KiB aligned
template <int DMAX>
struct Layout {
  static constexpr int WGS = DMAX > 128 ? 1 : 2;
  static constexpr int kBQ = kWgRows * WGS;
  static constexpr int kThreads = 128 * (WGS + 1);
  static constexpr int kProducerRegs = 40, kConsumerRegs = 232;
  // 64-key tiles where they fit: an m64n32k16 wgmma with both operands
  // in shared memory reads them 1.5 times faster than shared memory gives
  static constexpr int BKV = DMAX > 128 ? 32 : 64;
  static constexpr int NCH = DMAX / 64;
  static constexpr int kQChunk = kWgRows * 128;
  static constexpr int kKVChunk = BKV * 128;
  static constexpr int kQPart = NCH * kQChunk;
  static constexpr int kKVPart = NCH * kKVChunk;
  static constexpr int kQWg = 3 * kQPart;     // one warpgroup's Q parts
  static constexpr int kQ = WGS * kQWg;
  static constexpr int kSlot = 3 * kKVPart;
  static constexpr int kBars = 8 * (1 + 2 * kMaxSlots);
  static constexpr int kFit = (kSmemMax - 1024 - kQ - kBars) / kSlot;
  static constexpr int kSlots = kFit < kMaxSlots ? kFit : kMaxSlots;
  static constexpr int kSmem = 1024 + kQ + kSlots * kSlot + kBars;
  static_assert(kSlots >= 2, "ring too shallow");
};

// PARTS bf16 parts per operand: 3 (the split of fp32; a bf16 operand of a
// mixed call is split into itself and two zero parts) or 1 (all bf16).
// The passes and the DMAX / 16 k steps are fixed at compile time: a
// runtime test between two wgmma makes ptxas fence each one
// (warpgroup.arrive); columns past D are TMA's zeros.
template <int DMAX, int PARTS>
__global__ void __launch_bounds__(Layout<DMAX>::kThreads, 1) attn_tc_kernel(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, void* __restrict__ out,
    const Params p) {
  using Lay = Layout<DMAX>;
  constexpr int BKV = Lay::BKV, NCH = Lay::NCH, kSlots = Lay::kSlots,
                WGS = Lay::WGS, kBQ = Lay::kBQ;
  constexpr int kFirstS = PARTS == 3 ? 0 : 5;   // Q K^T's first pass
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_u32 = smem_u32(smem_raw);
  const uint32_t base = (raw_u32 + 1023) & ~1023u;   // 1 KiB for the swizzle
  const uint32_t qsm = base;
  const uint32_t ring = base + Lay::kQ;
  const uint32_t bars = ring + kSlots * Lay::kSlot;
  const uint32_t qbar = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kSlots + s); };

  const int t = threadIdx.x;
  if (t == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * WGS);   // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  int bhi, qt;
  block_tile(p, kBQ, blockIdx.x, bhi, qt);
  const int q0 = qt * kBQ;
  const int n_kv = (p.tk + BKV - 1) / BKV;
  auto next_live = [&](int j) {
    while (j < n_kv &&
           !tile_live(p, q0, q0 + kBQ - 1, j * BKV, j * BKV + BKV - 1))
      ++j;
    return j;
  };
  CK_BEGIN();
  CK(operand, kOpOut, static_cast<const unsigned char*>(out), ck::kOutput);
  CK(operand, kOpStats, p.stats, ck::kOutput);
  CK(ring, kRingQ, 1, ck::kMbarrier);
  CK(ring, kRingTC, kSlots, ck::kMbarrier);

  if (t >= 128 * WGS) {
    // producer warpgroup: its first thread loads each consumer's Q parts,
    // then K's and V's parts of every live tile into the ring (load n into
    // slot n % kSlots)
    if constexpr (WGS == 2) regs_down<Lay::kProducerRegs>();
    if (t != 128 * WGS) return;
    mbar_expect_tx(qbar, WGS * PARTS * NCH * Lay::kQChunk,
                   CK_TAG(true, kRingQ, 0, 0));
    // boxes past D and past Tq rely on TMA's zero fill
    for (int w = 0; w < WGS; ++w)
      for (int pt = 0; pt < PARTS; ++pt)
        for (int ch = 0; ch < NCH; ++ch)
          tma_3d(qsm + w * Lay::kQWg + pt * Lay::kQPart + ch * Lay::kQChunk,
                 &map_q, qbar, 64 * ch, q0 + kWgRows * w, bhi + pt * p.bh,
                 CK_BOX(true, kOpQ, 64, kWgRows, 1, ck::kZeroFill));
    int n = 0;
    for (int j = next_live(0); j < n_kv; j = next_live(j + 1)) {
      for (int op = 0; op < 2; ++op, ++n) {   // K, then V
        const CUtensorMap* map = op ? &map_v : &map_k;
        const int s = n % kSlots;
        mbar_wait(empty(s), ((n / kSlots) & 1) ^ 1);
        mbar_expect_tx(full(s), PARTS * NCH * Lay::kKVChunk,
                       CK_TAG(true, kRingTC, s, 0));
        const uint32_t st = ring + s * Lay::kSlot;
        // boxes past D and past Tk rely on TMA's zero fill
        for (int pt = 0; pt < PARTS; ++pt)
          for (int ch = 0; ch < NCH; ++ch)
            tma_3d(st + pt * Lay::kKVPart + ch * Lay::kKVChunk, map, full(s),
                   64 * ch, j * BKV, bhi + pt * p.bh,
                   CK_BOX(true, op ? kOpV : kOpK, 64, BKV, 1, ck::kZeroFill));
      }
    }
    return;
  }

  // consumer warpgroup wg (rows 64 wg .. 64 wg + 63 of the tile, its own
  // Q parts): the accumulator fragment of m64nN gives thread t rows ra and
  // ra + 8 and, in n8 block i, columns 8 i + 2 (lane % 4) + {0, 1}
  // (register 4 i + 2 h + e: row h, column e)
  if constexpr (WGS == 2) regs_up<Lay::kConsumerRegs>();
  const int wg = t / 128;
  const int warp = (t % 128) / 32;
  const int lane = t % 32;
  const int ra = kWgRows * wg + 16 * warp + lane / 4;
  const uint32_t qwg = qsm + wg * Lay::kQWg;
  const int r_lo = q0 + kWgRows * wg;     // this warpgroup's first row
  int row[2];
  bool rvalid[2];
  long long qpos[2], qlo[2];
  float m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = q0 + ra + 8 * h;
    rvalid[h] = row[h] < p.tq;
    qpos[h] = q_pos(p, row[h]);
    qlo[h] = tpu_q_lo(p, row[h]);
    m[h] = kMasked;
    l[h] = 0.f;
  }
  float acc[NCH][32];
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[ch][x] = 0.f;

  // thread 0 of a warpgroup logs its events (t % 128 == 0)
  mbar_wait(qbar, 0, CK_TAG(t % 128 == 0, kRingQ, 0, wg + 1));
  CK_IF(t % 128 == 0, read, kRingQ, 0, wg + 1);
  int n = 0;
  for (int j = next_live(0); j < n_kv; j = next_live(j + 1)) {
    const int sk = n % kSlots;
    const uint32_t phk = (n / kSlots) & 1;
    ++n;
    const int sv = n % kSlots;
    const uint32_t phv = (n / kSlots) & 1;
    ++n;

    // S = Q K^T over the passes, in a fresh fragment
    float s[BKV / 2];
    mbar_wait(full(sk), phk, CK_TAG(t % 128 == 0, kRingTC, sk, wg + 1));
    CK_IF(t % 128 == 0, read, kRingTC, sk, wg + 1);
    const uint32_t kst = ring + sk * Lay::kSlot;
    wgmma_fence();
#pragma unroll
    for (int ps = 0; ps < 6; ++ps) {
      if (pass_a(ps) < PARTS && pass_b(ps) < PARTS) {
#pragma unroll
        for (int kk = 0; kk < DMAX / 16; ++kk) {
          const uint32_t in_chunk = (kk & 3) * 32;
          const uint64_t da = smem_desc(qwg + pass_a(ps) * Lay::kQPart +
                                            (kk >> 2) * Lay::kQChunk +
                                            in_chunk,
                                        16, 1024);
          const uint64_t db = smem_desc(kst + pass_b(ps) * Lay::kKVPart +
                                            (kk >> 2) * Lay::kKVChunk +
                                            in_chunk,
                                        16, 1024);
          // the first product of the batch overwrites the fragment
          wgmma_ss<BKV>(s, da, db, ps != kFirstS || kk != 0);
        }
      }
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int x = 0; x < BKV / 2; ++x) fence_operand(s[x]);
    __syncwarp();
    if (lane == 0)
      mbar_arrive(empty(sk), CK_TAG(t % 128 == 0, kRingTC, sk, wg + 1));

    // scale, masks, online softmax (rows reduced over the lane quad)
    const bool plain = tile_unmasked(p, r_lo, r_lo + kWgRows - 1, j * BKV,
                                     j * BKV + BKV - 1);
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kAbsent;
#pragma unroll
      for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * i + 2 * h + e;
          const int key = j * BKV + 8 * i + 2 * (lane & 3) + e;
          s[x] = plain ? s[x] * p.scale
                       : score(p, rvalid[h], qlo[h], qpos[h], key, s[x]);
          mx = fmaxf(mx, s[x]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      alpha[h] = expf(m[h] - m_new);
      float ls = 0.f;
#pragma unroll
      for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * i + 2 * h + e;
          s[x] = expf(s[x] - m_new);
          ls += s[x];
        }
      ls += __shfl_xor_sync(0xffffffffu, ls, 1);
      ls += __shfl_xor_sync(0xffffffffu, ls, 2);
      l[h] = l[h] * alpha[h] + ls;
      m[h] = m_new;
    }

    // P's three bf16 parts as wgmma A fragments: k16 step kk takes
    // registers 8 kk .. 8 kk + 7 of the accumulator layout, in pairs
    uint32_t pa[3][BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const float v0 = s[8 * kk + 2 * qq], v1 = s[8 * kk + 2 * qq + 1];
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(v0, v1);
        const float2 hf = __bfloat1622float2(h2);
        const float r0 = __fsub_rn(v0, hf.x), r1 = __fsub_rn(v1, hf.y);
        const __nv_bfloat162 m2 = __floats2bfloat162_rn(r0, r1);
        const float2 mf = __bfloat1622float2(m2);
        pa[0][kk][qq] = bits(h2);
        pa[1][kk][qq] = bits(m2);
        pa[2][kk][qq] = bits(__floats2bfloat162_rn(__fsub_rn(r0, mf.x),
                                                   __fsub_rn(r1, mf.y)));
      }
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int x = 0; x < 32; ++x) acc[ch][x] *= alpha[(x >> 1) & 1];

    // acc += P V, 64 columns at a time, each in a fresh fragment added in
    // fp32 (V is MN-major: a k16 step is 16 key rows, 2 KiB, on)
    mbar_wait(full(sv), phv, CK_TAG(t % 128 == 0, kRingTC, sv, wg + 1));
    CK_IF(t % 128 == 0, read, kRingTC, sv, wg + 1);
    const uint32_t vst = ring + sv * Lay::kSlot;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      float f[32];
      wgmma_fence();
#pragma unroll
      for (int ps = 0; ps < 6; ++ps) {
        if (pass_b(ps) < PARTS) {
#pragma unroll
          for (int kk = 0; kk < BKV / 16; ++kk) {
            const uint64_t db =
                smem_desc(vst + pass_b(ps) * Lay::kKVPart +
                              ch * Lay::kKVChunk + kk * 2048,
                          Lay::kKVChunk, 1024);
            wgmma_rs_n64(f, pa[pass_a(ps)][kk], db, ps != 0 || kk != 0);
          }
        }
      }
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        fence_operand(f[x]);
        acc[ch][x] = __fadd_rn(acc[ch][x], f[x]);
      }
    }
    __syncwarp();
    if (lane == 0)
      mbar_arrive(empty(sv), CK_TAG(t % 128 == 0, kRingTC, sv, wg + 1));
  }
  CK_IF(t % 128 == 0 && r_lo < p.tq && p.stats, gwrite, kOpStats, p.stats,
        p.stats + 2 * (static_cast<long long>(bhi) * p.tq + r_lo), 1,
        2 * min(kWgRows, p.tq - r_lo));
  CK_IF(t % 128 == 0 && r_lo < p.tq, gwrite, kOpOut,
        static_cast<const unsigned char*>(out),
        static_cast<const unsigned char*>(out) +
            (static_cast<long long>(bhi) * p.tq + r_lo) * p.d *
                (p.out_bf16 ? 2 : 4),
        1, min(kWgRows, p.tq - r_lo) * p.d * (p.out_bf16 ? 2 : 4));

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!rvalid[h]) continue;
    if ((lane & 3) == 0) write_stats(p, bhi, row[h], m[h], l[h]);
    const float den = fmaxf(l[h], 1e-30f);
    const long long orow = (static_cast<long long>(bhi) * p.tq + row[h]) * p.d;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 64 * ch + 8 * i + 2 * (lane & 3);
        if (col < p.d)
          store2(out, orow + col, p.out_bf16, acc[ch][4 * i + 2 * h] / den,
                 acc[ch][4 * i + 2 * h + 1] / den);
      }
  }
}

}  // namespace tc

// ---- launches ---------------------------------------------------------------

template <typename TK, typename TV, int DMAX, int BQ>
int launch_simt(const void* q, const void* k, const void* v, void* out,
                float* work, int* counters, const Params& p, int split_keys,
                cudaStream_t stream) {
  using T = Tiles<DMAX, BQ>;
  constexpr size_t smem = simt_smem<TK, TV, DMAX, BQ>();
  auto kernel = attn_simt_kernel<TK, TV, DMAX, BQ>;
  // the opt-in to > 48 KB of dynamic shared memory is per device; set it
  // once (a repeated set is harmless, so the unlocked flag is enough)
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return -1;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev] = true;
  }
  const long long n_qt = (p.tq + BQ - 1) / BQ;
  const int n_kv = (p.tk + T::BKV - 1) / T::BKV;
  const int tps = split_keys > 0 ? split_keys / T::BKV : n_kv;
  const int n_splits = (n_kv + tps - 1) / tps;
  if (static_cast<long long>(p.bh) * n_qt > INT_MAX || n_splits > 65535)
    return -1;
  const dim3 grid(static_cast<unsigned>(p.bh * n_qt), n_splits);
  CK_LAUNCH("attn_simt_kernel", stream);
  kernel<<<grid, T::kThreads, smem, stream>>>(
      q, static_cast<const TK*>(k), static_cast<const TV*>(v), out, work,
      counters, p, tps);
  return static_cast<int>(cudaGetLastError());
}

template <typename TK, typename TV, int BQ>
int simt_by_dim(const void* q, const void* k, const void* v, void* out,
                float* work, int* counters, const Params& p, int split_keys,
                cudaStream_t s) {
  if (p.d <= 64)
    return launch_simt<TK, TV, 64, BQ>(q, k, v, out, work, counters, p,
                                       split_keys, s);
  if (p.d <= 128)
    return launch_simt<TK, TV, 128, BQ>(q, k, v, out, work, counters, p,
                                        split_keys, s);
  return launch_simt<TK, TV, 256, BQ>(q, k, v, out, work, counters, p,
                                      split_keys, s);
}

template <typename TK, typename TV>
int simt_by_rows(const void* q, const void* k, const void* v, void* out,
                 float* work, int* counters, const Params& p, int split_keys,
                 cudaStream_t s) {
  return p.tq <= 32 ? simt_by_dim<TK, TV, 32>(q, k, v, out, work, counters,
                                              p, split_keys, s)
                    : simt_by_dim<TK, TV, 64>(q, k, v, out, work, counters,
                                              p, split_keys, s);
}

// PARTS = 1 when q, k and v are all bf16 (read in place), else 3: the
// pre-pass writes each operand's three parts to `parts` once per call
template <int DMAX, int PARTS>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              bf16* parts, const int* is_bf16, const Params& p,
              cudaStream_t stream) {
  using Lay = tc::Layout<DMAX>;
  const long long n[3] = {static_cast<long long>(p.bh) * p.tq * p.d,
                          static_cast<long long>(p.bh) * p.tk * p.d,
                          static_cast<long long>(p.bh) * p.tk * p.d};
  const void* src[3] = {q, k, v};
  const int rows[3] = {tc::kWgRows, Lay::BKV, Lay::BKV};
  const int len[3] = {p.tq, p.tk, p.tk};
  CUtensorMap maps[3];
  for (int o = 0; o < 3; ++o) {
    const void* ptr = src[o];
    if (PARTS == 3) {
      const int rc = split3(src[o], is_bf16[o], parts, n[o], stream);
      if (rc != 0) return rc;
      ptr = parts;
      parts += 3 * n[o];
    }
    if (!encode3d(&maps[o], ptr, p.d, len[o],
                  static_cast<long long>(PARTS) * p.bh, rows[o]))
      return -2;
  }
  auto kernel = tc::attn_tc_kernel<DMAX, PARTS>;
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return -1;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev] = true;
  }
  const long long blocks =
      static_cast<long long>(p.bh) * ((p.tq + Lay::kBQ - 1) / Lay::kBQ);
  if (blocks > INT_MAX) return -1;
  CK_MAP(kOpQ, p.d, p.tq, static_cast<long long>(PARTS) * p.bh, stream);
  CK_MAP(kOpK, p.d, p.tk, static_cast<long long>(PARTS) * p.bh, stream);
  CK_MAP(kOpV, p.d, p.tk, static_cast<long long>(PARTS) * p.bh, stream);
  CK_LAUNCH("attn_tc_kernel", stream);
  kernel<<<static_cast<unsigned>(blocks), Lay::kThreads, Lay::kSmem,
           stream>>>(maps[0], maps[1], maps[2], out, p);
  return static_cast<int>(cudaGetLastError());
}

template <int PARTS>
int tc_by_dim(const void* q, const void* k, const void* v, void* out,
              bf16* parts, const int* is_bf16, const Params& p,
              cudaStream_t s) {
  if (p.d <= 64)
    return launch_tc<64, PARTS>(q, k, v, out, parts, is_bf16, p, s);
  if (p.d <= 128)
    return launch_tc<128, PARTS>(q, k, v, out, parts, is_bf16, p, s);
  return launch_tc<256, PARTS>(q, k, v, out, parts, is_bf16, p, s);
}

}  // namespace

CK_NAMES("op:0:q op:1:k op:2:v op:3:out op:4:work op:5:counters "
         "op:6:parts op:7:stats ring:0:kv_tiles ring:1:q_parts "
         "ring:2:kv_parts")

extern "C" {

// q (bh, tq, d), k/v (bh, tk, d), out (bh, tq, d): contiguous, 16-byte
// aligned; each of q, k, v fp32 (x_bf16 = 0) or bf16 (1), out fp32 or
// bf16.  d a multiple of 8 up to 256 (of 16 for path 2).  The masks and
// tiles are those of repro's flash_attention: has_window = 0 means no
// window; q_period = tq when the q axis holds one group.  path: 0 =
// "simt" (one split), 1 = "splitkv" (splits of split_keys keys, a
// multiple of 64; work: fp32 scratch of bh x ceil(tq / rows) x n_splits x
// rows x (d + 2) values, rows = 32 for tq <= 32 else 64; counters: as many
// int32 zeros, one per (bh, q tile), left at zero), 2 = "tc" (parts: bf16
// scratch for three parts of q, then of k, then of v, unless all three are
// bf16: then null).  stats: null, or (bh, tq) fp32 pairs that every path
// fills with each row's final (m, l) for the backward pass.
// Returns 0, a cudaError_t value, -1 for arguments out of range, or -2
// when a TMA descriptor cannot be made.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int q_bf16, int k_bf16, int v_bf16, int out_bf16, int bh,
                    int tq, int tk, int d, float scale, int causal,
                    int has_window, long long window, long long offset,
                    int kv_len, int bq, int bkv, int q_period, int path,
                    int split_keys, float* work, int* counters, void* parts,
                    float* stats, void* stream) {
  if (bh < 1 || tq < 1 || tk < 1 || d < 8 || d > 256 || d % 8 || bq < 1 ||
      bkv < 1 || q_period < 1 || path < 0 || path > 2)
    return -1;
  const Params p{bh,     tq,     tk,     d,   scale, causal, has_window,
                 window, offset, kv_len, bq,  bkv,   q_period, q_bf16,
                 out_bf16, stats};
  auto s = static_cast<cudaStream_t>(stream);
  if (path == 2) {
    if (d % 16) return -1;
    const int is_bf16[3] = {q_bf16, k_bf16, v_bf16};
    auto pb = static_cast<bf16*>(parts);
    return q_bf16 && k_bf16 && v_bf16
               ? tc_by_dim<1>(q, k, v, out, pb, is_bf16, p, s)
               : tc_by_dim<3>(q, k, v, out, pb, is_bf16, p, s);
  }
  if (path == 1 && (split_keys < kSplitUnit || split_keys % kSplitUnit))
    return -1;
  const int sk = path == 1 ? split_keys : 0;
  if (k_bf16)
    return v_bf16 ? simt_by_rows<bf16, bf16>(q, k, v, out, work, counters,
                                             p, sk, s)
                  : simt_by_rows<bf16, float>(q, k, v, out, work, counters,
                                              p, sk, s);
  return v_bf16 ? simt_by_rows<float, bf16>(q, k, v, out, work, counters, p,
                                            sk, s)
                : simt_by_rows<float, float>(q, k, v, out, work, counters, p,
                                             sk, s);
}

const char* flash_attention_error_string(int code) {
  if (code == -1) return "arguments out of range";
  if (code == -2) return "cuTensorMapEncodeTiled failed";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
