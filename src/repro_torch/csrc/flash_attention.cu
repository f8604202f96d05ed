// Fused attention with an online softmax (flash attention): causal,
// local-window and kv_len masks, fully masked KV tiles skipped, grouped
// queries through the q_period position wrap.  q (BH, Tq, D), k/v (BH, Tk,
// D), fp32 or bf16, converted to fp32 on use; out (BH, Tq, D) fp32 or bf16.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention.  Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a library with the plain C interface at the bottom of this file,
// loaded from Python with ctypes (src/repro_torch/kernels/build.py).
//
// Work decomposition.  The TPU grid walks (bh, q tile, kv tile) with the
// kv axis innermost and keeps the running max m, denominator l and
// accumulator in VMEM.  Here one thread block owns kBQ = 64 query rows of
// one bh and loops over the KV tiles itself, with m, l and the accumulator
// in registers.  256 threads: the 16 threads of a half-warp share 4 query
// rows (row group rg = t / 16); for S = Q K^T a thread computes those rows
// against keys c, c + 16, ... of the tile (c = t % 16), and for P V it owns
// the columns 4 c .. 4 c + 3 (+ 64, + 128, + 192) of those rows.  Row
// maxima and sums are reduced across the half-warp with shuffles; P goes
// through shared memory to the P V product.  Q is converted to fp32 in
// shared memory once; K and V tiles move as raw bytes (fp32 or bf16)
// through a two-stage cp.async ring, the next live tile in flight while the
// current one is used.  Head dims up to 256 (multiples of 8); the KV tile is
// 64 keys for D <= 128 and 32 keys above, so that the fp32 ring, the Q tile
// and P fit the 227 KB of shared memory a block may opt into.
//
// Masks and skipping follow the TPU kernel exactly.  A KV tile of the TPU
// grid (bkv keys) is live for a TPU q tile (bq rows) when its first key is
// below kv_len, not after the q tile's last position (causal) and its last
// key is inside the window of the q tile's first position.  In a live TPU
// tile a masked key scores the finite -1e30 (as in repro, never -inf): a
// row whose live tiles hold only masked keys takes weight exp(0) = 1 on
// them, and a later live key wipes them with alpha = exp(-1e30 - m) = 0.
// A key in a dead TPU tile, or past Tk, takes no part at all.  This
// kernel's own tiles need not match bq and bkv: each element is classed by
// the TPU tiles its row and key fall in (the q_period wrap included), and a
// tile of this kernel is skipped when no pair of TPU tiles it overlaps is
// live.  So only the order of summation differs from the TPU kernel.  The
// output is acc / max(l, 1e-30).  expf and true division, no fast-math.
//
// Bound.  4 D fp32 operations per live (query, key) pair (Q K^T and P V):
// granite-3-8b prefill (T = 4096, 32 heads, D = 128, causal) is 137 GFLOP,
// 2.05 ms at the 67 TFLOP/s fp32 CUDA-core peak; RecurrentGemma-9B's local
// block (T = 8192, 16 heads, D = 256, window 2048) 240 GFLOP, 3.6 ms.
// Decode (one query row per head) reads the whole K/V cache once: bytes
// bind there.  The inner loops read Q and K, and P and V, as float4s from
// shared memory for 4 x 4 (S) and 4 x 4 x 4 (P V) FMAs a step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;
constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
constexpr float kMasked = -1e30f;    // repro's finite "minus infinity"
constexpr float kAbsent = -3e38f;    // a key outside every live TPU tile

template <int DMAX>
struct Tiles {
  static constexpr int BKV = DMAX > 128 ? 32 : 64;
  static constexpr int NJ = BKV / 16;   // keys a thread scores per tile
  static constexpr int NC = DMAX / 64;  // float4 column groups per thread
  static constexpr int QP = DMAX + 4;   // fp32 Q row stride (16-byte pad)
  static constexpr int PP = BKV + 4;    // fp32 P row stride
};

template <typename TI, int DMAX>
__host__ __device__ constexpr int kv_stride() {           // K/V row stride in elements
  return DMAX + 16 / int(sizeof(TI));
}

template <typename TI, int DMAX>
constexpr size_t smem_bytes() {
  using T = Tiles<DMAX>;
  return sizeof(float) * (size_t(kBQ) * T::QP + size_t(kBQ) * T::PP) +
         sizeof(TI) * size_t(2 * 2 * T::BKV) * kv_stride<TI, DMAX>();
}

__device__ __forceinline__ float4 read4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 read4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// 16 bytes global -> shared; src_bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

struct Params {
  int tq, tk, d;
  float scale;
  int causal, has_window;
  long long window;
  long long offset;
  int kv_len, bq, bkv, q_period;
};

template <typename TI, typename TO, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const TI* __restrict__ q, const TI* __restrict__ k,
    const TI* __restrict__ v, TO* __restrict__ out, const Params p) {
  using T = Tiles<DMAX>;
  constexpr int BKV = T::BKV, NJ = T::NJ, NC = T::NC, QP = T::QP,
                PP = T::PP;
  constexpr int KP = kv_stride<TI, DMAX>();
  constexpr int EPC = 16 / int(sizeof(TI));   // elements per 16-byte chunk

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ps = qs + kBQ * QP;
  TI* kvs = reinterpret_cast<TI*>(ps + kBQ * PP);   // [stage][K, V][BKV][KP]

  const int t = threadIdx.x;
  const int c = t & 15;
  const int rg = t >> 4;
  const int D = p.d;
  const long long bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int n_kv = (p.tk + BKV - 1) / BKV;
  const TI* qb = q + bh * p.tq * D;
  const TI* kb = k + bh * p.tk * D;
  const TI* vb = v + bh * p.tk * D;

  // Q tile to fp32 shared memory (rows past Tq read as 0)
  for (int idx = t; idx < kBQ * (D / 4); idx += kThreads) {
    const int r = idx / (D / 4);
    const int d4 = (idx % (D / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < p.tq) val = read4(qb + static_cast<long long>(q0 + r) * D + d4);
    *reinterpret_cast<float4*>(qs + r * QP + d4) = val;
  }

  // TPU tile liveness: q tile with first position q_lo, kv tile from k_lo
  auto tpu_live = [&](long long q_lo, long long k_lo) {
    bool live = k_lo < p.kv_len;
    if (p.causal) live = live && k_lo <= q_lo + p.bq - 1;
    if (p.has_window) live = live && k_lo + p.bkv - 1 > q_lo - p.window;
    return live;
  };
  auto tpu_q_lo = [&](int row) {   // first position of the row's TPU q tile
    return p.offset + static_cast<long long>((row / p.bq) * p.bq) % p.q_period;
  };
  // this kernel's KV tile j is live when any TPU tile pair it overlaps is
  auto tile_live = [&](int j) {
    const int k_first = j * BKV;
    const int k_last = min(k_first + BKV, p.tk) - 1;
    const int r_last = min(q0 + kBQ, p.tq) - 1;
    for (int qt = q0 / p.bq; qt <= r_last / p.bq; ++qt) {
      const long long q_lo = tpu_q_lo(qt * p.bq);
      for (int kt = k_first / p.bkv; kt <= k_last / p.bkv; ++kt)
        if (tpu_live(q_lo, static_cast<long long>(kt) * p.bkv)) return true;
    }
    return false;
  };
  auto next_live = [&](int j) {
    while (j < n_kv && !tile_live(j)) ++j;
    return j;
  };
  auto issue = [&](int j, int s) {
    if (j < n_kv) {
      TI* ks = kvs + (2 * s) * BKV * KP;
      TI* vs = ks + BKV * KP;
      const int cpr = D / EPC;              // 16-byte chunks per row
      for (int idx = t; idx < BKV * cpr; idx += kThreads) {
        const int r = idx / cpr;
        const int e = (idx % cpr) * EPC;
        const int key = j * BKV + r;
        const bool ok = key < p.tk;
        const long long off = ok ? static_cast<long long>(key) * D + e : 0;
        cp_async16(ks + r * KP + e, kb + off, ok ? 16 : 0);
        cp_async16(vs + r * KP + e, vb + off, ok ? 16 : 0);
      }
    }
    cp_async_commit();   // empty groups keep the wait count uniform
  };

  // per-row state: position, TPU tile start, running max / sum
  long long qpos[4], qlo[4];
  bool rvalid[4];
  float m[4], l[4], acc[4][NC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + rg * 4 + i;
    rvalid[i] = r < p.tq;
    qpos[i] = p.offset + r % p.q_period;
    qlo[i] = tpu_q_lo(r);
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][cc][u] = 0.f;
  }

  int j = next_live(0);
  issue(j, 0);
  int jn = j < n_kv ? next_live(j + 1) : n_kv;
  int s = 0;
  while (j < n_kv) {
    issue(jn, s ^ 1);
    cp_async_wait<1>();   // tile j landed (this thread's copies)
    __syncthreads();      // everyone's copies and the Q tile visible
    const TI* ks = kvs + (2 * s) * BKV * KP;
    const TI* vs = ks + BKV * KP;

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
        const float4 kv = read4(ks + (c + 16 * jj) * KP + d);
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
        const int key = j * BKV + c + 16 * jj;
        const bool in_tile =
            rvalid[i] && key < p.tk &&
            tpu_live(qlo[i], static_cast<long long>(key / p.bkv) * p.bkv);
        bool ok = key < p.kv_len;
        if (p.causal) ok = ok && key <= qpos[i];
        if (p.has_window) ok = ok && key > qpos[i] - p.window;
        sv[jj] = in_tile ? (ok ? sc[i][jj] * p.scale : kMasked) : kAbsent;
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
            const float4 vv = read4(vs + (kk + u) * KP + col);
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
    j = jn;
    jn = j < n_kv ? next_live(j + 1) : n_kv;
    s ^= 1;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!rvalid[i]) continue;
    const float den = fmaxf(l[i], 1e-30f);
    TO* orow = out + (bh * p.tq + q0 + rg * 4 + i) * D;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int col = 4 * c + 64 * cc;
      if (col < D) {
        float o[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) o[u] = acc[i][cc][u] / den;
        store4(orow + col, o);
      }
    }
  }
}

template <typename TI, typename TO, int DMAX>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<TI, DMAX>();
  auto kernel = flash_attention_kernel<TI, TO, DMAX>;
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
  const dim3 grid((p.tq + kBQ - 1) / kBQ, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TI*>(q), static_cast<const TI*>(k),
      static_cast<const TI*>(v), static_cast<TO*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename TI, typename TO>
int by_dim(const void* q, const void* k, const void* v, void* out, int bh,
           const Params& p, cudaStream_t s) {
  if (p.d <= 64) return launch<TI, TO, 64>(q, k, v, out, bh, p, s);
  if (p.d <= 128) return launch<TI, TO, 128>(q, k, v, out, bh, p, s);
  return launch<TI, TO, 256>(q, k, v, out, bh, p, s);
}

}  // namespace

extern "C" {

// q (bh, tq, d), k/v (bh, tk, d), out (bh, tq, d): contiguous, 16-byte
// aligned; q/k/v all fp32 (in_bf16 = 0) or all bf16 (1), out fp32 or bf16.
// d a multiple of 8, at most 256.  The masks and tiles are those of
// repro's flash_attention: has_window = 0 means no window; q_period = tq
// when the q axis holds one group.  Returns 0, a cudaError_t value, or -1 for
// arguments out of range.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int bh, int tq, int tk, int d, float scale, int causal,
                    int has_window, long long window, long long offset,
                    int kv_len, int bq,
                    int bkv, int q_period, int in_bf16, int out_bf16,
                    void* stream) {
  if (bh < 1 || bh > 65535 || tq < 1 || tk < 1 || d < 8 || d > 256 ||
      d % 8 || bq < 1 || bkv < 1 || q_period < 1)
    return -1;
  const Params p{tq,     tk,     d,      scale, causal, has_window,
                 window, offset, kv_len, bq,    bkv,    q_period};
  auto s = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return out_bf16 ? by_dim<__nv_bfloat16, __nv_bfloat16>(q, k, v, out, bh,
                                                           p, s)
                    : by_dim<__nv_bfloat16, float>(q, k, v, out, bh, p, s);
  return out_bf16 ? by_dim<float, __nv_bfloat16>(q, k, v, out, bh, p, s)
                  : by_dim<float, float>(q, k, v, out, bh, p, s);
}

const char* flash_attention_error_string(int code) {
  if (code == -1) return "arguments out of range";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
