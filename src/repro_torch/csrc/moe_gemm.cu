// Grouped expert GEMM over expert-sorted token chunks (the MoE FFN's two
// matmuls): out[c * rows + r, :] = x[c * rows + r, :] @ w[chunk_expert[c]],
// every operand converted to fp32, fp32 accumulation, fp32 or bf16 out.
//
// Replaces the TPU kernel src/repro/kernels/moe_gemm.py::moe_gemm.  Built
// with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a library with the plain C interface at the bottom of this file,
// loaded from Python with ctypes (src/repro_torch/kernels/build.py).
//
// Work decomposition.  The TPU grid walks (chunk, N tile of bn columns) and
// scalar-prefetches chunk_expert to pick the weight block.  Here one thread
// block computes a kBM x kBN (128 x 128) tile of one chunk: blockIdx.x is
// the chunk's M tile (a chunk of more than 128 rows has several, the last
// one masked at the chunk's end, so a tile never straddles two experts),
// blockIdx.y the N tile; the block reads chunk_expert[c] from device memory
// itself, so nothing syncs to the host.  Chunks padded with zero rows are
// computed, as in the TPU kernel.  bn is only validated by the wrapper: the
// CUDA tile need not be bn, and ragged N and K edges are masked.
//
// Arithmetic.  256 threads; a thread owns an 8 x 8 block of the tile (rows
// 4 ty .. 4 ty + 3 and 64 + the same, columns 4 tx .. 4 tx + 3 and 64 + the
// same), so each step along k reads four float4s from shared memory for 64
// FMAs, all fp32 on the CUDA cores (fmaf, never TF32).  The K axis moves in
// steps of kBK = 8 through two shared-memory stages: the next step's x and
// w tiles are loaded into registers (and converted from bf16 there) while
// the current step is multiplied, then stored into the other stage.  The x
// tile is stored transposed (k-major, padded rows) so the inner loop reads
// rows of the tile as float4s.
//
// Bound.  At Llama-4 Maverick's expert widths (d_model 5120, d_ff 8192, 128
// experts, T = 4096 tokens at top-1 and capacity 1.25: 16,384 buffer rows)
// each call does 2 * 16384 * 5120 * 8192 = 1.37 TFLOP and moves 11.4 GB
// (10.7 GB of bf16 weights, the bf16 rows, the fp32 output).  With bf16 x
// and w the products are exact in fp32, so the bf16 tensor-core peak (989
// TFLOP/s, 1.4 ms) applies and the bytes bind: 3.4 ms at 3.35 TB/s.  This
// kernel's fp32 FMAs on the CUDA cores have a ceiling of 20.5 ms (67
// TFLOP/s); tensor cores (mma / wgmma) are the way past it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 8;
constexpr int kThreads = 256;
// two resident blocks an SM (at most 128 registers a thread): with one, two
// warps a scheduler cannot hide the shared-memory latency of the FMA loop
constexpr int kBlocksPerSM = 2;
constexpr int kAP = kBM + 4;   // padded k-major x row, 16-byte aligned

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Four consecutive elements from p as fp32, of which the first `n` exist
// (the rest read as 0; n <= 0 reads nothing).  With VEC the wrapper
// guarantees that a full group is aligned for one vector load.
template <typename TI, bool VEC>
__device__ __forceinline__ float4 load4(const TI* p, int n) {
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if (n <= 0) return r;
  if (VEC && n >= 4) {
    if constexpr (sizeof(TI) == 4) {
      return *reinterpret_cast<const float4*>(p);
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      const float2 lo = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 hi = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u.y));
      return make_float4(lo.x, lo.y, hi.x, hi.y);
    }
  }
  r.x = to_f32(p[0]);
  if (n > 1) r.y = to_f32(p[1]);
  if (n > 2) r.z = to_f32(p[2]);
  if (n > 3) r.w = to_f32(p[3]);
  return r;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// The first min(n, 4) of v[0..3] to p (n <= 0 writes nothing).
template <typename TO, bool VEC>
__device__ __forceinline__ void store4(TO* p, float v0, float v1, float v2,
                                       float v3, int n) {
  if (n <= 0) return;
  if (VEC && n >= 4) {
    if constexpr (sizeof(TO) == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v0, v1, v2, v3);
    } else {
      __nv_bfloat162 lo = __floats2bfloat162_rn(v0, v1);
      __nv_bfloat162 hi = __floats2bfloat162_rn(v2, v3);
      uint2 u;
      u.x = *reinterpret_cast<unsigned*>(&lo);
      u.y = *reinterpret_cast<unsigned*>(&hi);
      *reinterpret_cast<uint2*>(p) = u;
    }
    return;
  }
  store1(p, v0);
  if (n > 1) store1(p + 1, v1);
  if (n > 2) store1(p + 2, v2);
  if (n > 3) store1(p + 3, v3);
}

template <typename TX, typename TW, typename TO, bool VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) moe_gemm_kernel(
    const TX* __restrict__ x, const TW* __restrict__ w,
    const int* __restrict__ chunk_expert, TO* __restrict__ out,
    int chunk_rows, int m_tiles, int d_in, int d_out) {
  __shared__ __align__(16) float xs[2][kBK][kAP];
  __shared__ __align__(16) float ws[2][kBK][kBN];

  const int t = threadIdx.x;
  const int chunk = blockIdx.x / m_tiles;
  const int mt = blockIdx.x % m_tiles;
  const int rows = min(kBM, chunk_rows - mt * kBM);   // live rows of the tile
  const long long row0 = static_cast<long long>(chunk) * chunk_rows + mt * kBM;
  const int n0 = blockIdx.y * kBN;
  const int e = chunk_expert[chunk];
  const TW* we = w + static_cast<long long>(e) * d_in * d_out;

  // loader roles: x tile 128 rows x 8 k (row t/2, k group (t%2)*4); w tile
  // 8 k x 128 columns (k row t/32, column group (t%32)*4)
  const int xr = t >> 1;
  const int xk = (t & 1) * 4;
  const int wk = t >> 5;
  const int wn = (t & 31) * 4;
  const TX* xp = x + (row0 + xr) * d_in + xk;
  const TW* wp = we + static_cast<long long>(wk) * d_out + n0 + wn;
  const bool x_live = xr < rows;
  const int w_cols = d_out - (n0 + wn);

  auto fetch = [&](int k0, float4& xv, float4& wv) {
    xv = load4<TX, VEC>(xp + k0, x_live ? d_in - (k0 + xk) : 0);
    wv = load4<TW, VEC>(wp + static_cast<long long>(k0) * d_out,
                        k0 + wk < d_in ? w_cols : 0);
  };
  auto stash = [&](int s, const float4& xv, const float4& wv) {
    xs[s][xk + 0][xr] = xv.x;
    xs[s][xk + 1][xr] = xv.y;
    xs[s][xk + 2][xr] = xv.z;
    xs[s][xk + 3][xr] = xv.w;
    *reinterpret_cast<float4*>(&ws[s][wk][wn]) = wv;
  };

  const int tx = t & 15;
  const int ty = t >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float4 xv, wv;
  fetch(0, xv, wv);
  stash(0, xv, wv);
  __syncthreads();
  const int n_k = (d_in + kBK - 1) / kBK;
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < n_k) fetch((kt + 1) * kBK, xv, wv);   // in flight
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[s][k][4 * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&xs[s][k][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[s][k][4 * tx]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&ws[s][k][64 + 4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < n_k) stash(s ^ 1, xv, wv);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (r >= rows) continue;
    TO* orow = out + (row0 + r) * d_out;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + 64 * h + 4 * tx;
      store4<TO, VEC>(orow + col, acc[i][4 * h], acc[i][4 * h + 1],
                      acc[i][4 * h + 2], acc[i][4 * h + 3], d_out - col);
    }
  }
}

template <typename TX, typename TW, typename TO>
int launch(const void* x, const void* w, const int* chunk_expert, void* out,
           int n_chunks, int chunk_rows, int d_in, int d_out, int vec,
           cudaStream_t stream) {
  const int m_tiles = (chunk_rows + kBM - 1) / kBM;
  const dim3 grid(n_chunks * m_tiles, (d_out + kBN - 1) / kBN);
  auto args = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TW*>(w), chunk_expert,
        static_cast<TO*>(out), chunk_rows, m_tiles, d_in, d_out);
  };
  if (vec)
    args(moe_gemm_kernel<TX, TW, TO, true>);
  else
    args(moe_gemm_kernel<TX, TW, TO, false>);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TW>
int by_out(int out_bf16, const void* x, const void* w, const int* ce,
           void* out, int n_chunks, int chunk_rows, int d_in, int d_out,
           int vec, cudaStream_t s) {
  return out_bf16 ? launch<TX, TW, __nv_bfloat16>(x, w, ce, out, n_chunks,
                                                  chunk_rows, d_in, d_out,
                                                  vec, s)
                  : launch<TX, TW, float>(x, w, ce, out, n_chunks,
                                          chunk_rows, d_in, d_out, vec, s);
}

}  // namespace

extern "C" {

// x (n_chunks * chunk_rows, d_in), w (E, d_in, d_out), out (n_chunks *
// chunk_rows, d_out): contiguous row-major; x and w each fp32 (0) or bf16
// (1), out fp32 (0) or bf16 (1); chunk_expert (n_chunks,) int32 on the
// device.  vec = 1 promises d_in % 4 == 0, d_out % 4 == 0 and 16-byte
// aligned x, w and out.  Returns 0, a cudaError_t value, or -1 for a shape
// out of range.
int moe_gemm(const void* x, const void* w, const int* chunk_expert,
             void* out, int n_chunks, int chunk_rows, int d_in, int d_out,
             int x_bf16, int w_bf16, int out_bf16, int vec, void* stream) {
  if (n_chunks < 1 || chunk_rows < 1 || d_in < 1 || d_out < 1 ||
      (d_out + kBN - 1) / kBN > 65535)
    return -1;
  auto s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && w_bf16)
    return by_out<__nv_bfloat16, __nv_bfloat16>(out_bf16, x, w, chunk_expert,
                                                out, n_chunks, chunk_rows,
                                                d_in, d_out, vec, s);
  if (x_bf16)
    return by_out<__nv_bfloat16, float>(out_bf16, x, w, chunk_expert, out,
                                        n_chunks, chunk_rows, d_in, d_out,
                                        vec, s);
  if (w_bf16)
    return by_out<float, __nv_bfloat16>(out_bf16, x, w, chunk_expert, out,
                                        n_chunks, chunk_rows, d_in, d_out,
                                        vec, s);
  return by_out<float, float>(out_bf16, x, w, chunk_expert, out, n_chunks,
                              chunk_rows, d_in, d_out, vec, s);
}

const char* moe_gemm_error_string(int code) {
  if (code == -1) return "shape out of range";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
