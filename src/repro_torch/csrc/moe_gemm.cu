// Grouped expert GEMM over expert-sorted token chunks (the MoE FFN's two
// matmuls): out[c * rows + r, :] = x[c * rows + r, :] @ w[chunk_expert[c]],
// fp32 accumulation, fp32 or bf16 out.  With live_rows, the rows of chunk c
// from live_rows[c] on are written as zeros and never multiplied (the
// caller promises that those rows of x are zero, so the product is the
// same).
//
// Replaces the TPU kernel src/repro/kernels/moe_gemm.py::moe_gemm.  Built
// with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a library with the plain C interface at the bottom of this file,
// loaded from Python with ctypes (src/repro_torch/kernels/build.py).  Two
// kernels; the wrapper picks one before the launch, by type and shape:
//
// 1. tc::moe_gemm_tc, bf16 x and bf16 w (the case moe_apply runs at every
//    published MoE width), d_in % 8 == 0, d_out % 8 == 0, 16-byte-aligned
//    bases.  Bound.  At Llama-4 Maverick's expert widths (d_model 5120,
//    d_ff 8192, 128 experts, T = 4096 tokens at top-1 and capacity 1.25:
//    16,384 buffer rows) a call does 2 * 16384 * 5120 * 8192 = 1.37 TFLOP
//    and moves 11.4 GB (10.7 GB of bf16 weights, the bf16 rows, the fp32
//    output): 1.4 ms at the bf16 tensor-core peak (989 TFLOP/s), 3.4 ms at
//    3.35 TB/s.  128 FLOP a weight byte is under the card's ridge (~295),
//    so the bytes bind and the depth of the load pipeline matters more than
//    the MMA shape.  The product of two bf16 values is exact in fp32, so
//    bf16 tensor cores with fp32 accumulation compute the same function up
//    to the order of the sum.  Design:
//    - One persistent thread block an SM walks the (M tile, N tile) tiles
//      of 128 x 128 with the N tile fastest, so the blocks in flight share
//      one or two chunks' x rows (re-read from L2) and each weight tile is
//      read once from device memory.  An M tile never straddles two chunks
//      (a chunk of more than 128 rows has several; the last one's rows past
//      the chunk's end are loaded but never stored).
//    - Warpgroup 0 is the producer: one thread keeps a ring of kStages
//      shared-memory stages full with TMA (2-D tensor map on x as (rows,
//      d_in), 3-D on w as (E, d_in, d_out), so the expert is a coordinate
//      and a K tile past d_in is zero-filled within its expert; 64 x 64
//      bf16 boxes under the 128-byte swizzle; weights evict-first in L2,
//      x rows evict-last), each stage tracked by a "full" mbarrier (TMA
//      bytes) and an "empty" one (consumer warps).
//    - Warpgroups 1 and 2 consume: each owns 64 rows of the tile and runs
//      wgmma m64n128k16 bf16 -> fp32 on the stages that have arrived, A
//      (x) K-major, B (w, N-contiguous) MN-major through the transpose bit.
//      Each 64-deep K step is summed in the tensor cores into a scratch
//      accumulator, which is then added into the tile's fp32 accumulator
//      on the CUDA cores, so the long sum over d_in is an IEEE fp32 sum of
//      64-term partial sums.
//    - The expert id and the live-row count are read on the device; a tile
//      whose rows are all dead costs no load (zeros are written), and a
//      dead 64-row half loads no x and issues no wgmma.
//    - Stores go from the accumulator registers straight to global memory,
//      masked at the chunk's end, at d_out, and to zero past the live
//      count; the producer meanwhile fills the ring for the next tile.
//
// 2. simt::moe_gemm_kernel, every other call (fp32 or mixed operands, other
//    widths or alignments): one thread block a 128 x 128 tile of one chunk,
//    256 threads, an 8 x 8 register block a thread, fp32 FMAs on the CUDA
//    cores (never TF32) over kBK = 8 steps through two shared-memory
//    stages; its fp32 FMA ceiling at Maverick's widths is 20.5 ms (67
//    TFLOP/s).  A tile whose rows are all past the live count writes zeros.
#include <cuda.h>          // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

// the checked build's operands and ring (check.cuh)
enum CkOp { kOpX = 0, kOpW, kOpExpert, kOpLive, kOpOut };
constexpr int kRingTiles = 0;   // tc: a stage holds x's and w's boxes

// ---------------------------------------------------------------------------
// simt: the CUDA-core kernel
// ---------------------------------------------------------------------------
namespace simt {

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
    const int* __restrict__ chunk_expert, const int* __restrict__ live_rows,
    TO* __restrict__ out, int chunk_rows, int m_tiles, int d_in, int d_out) {
  __shared__ __align__(16) float xs[2][kBK][kAP];
  __shared__ __align__(16) float ws[2][kBK][kBN];

  const int t = threadIdx.x;
  const int chunk = blockIdx.x / m_tiles;
  const int mt = blockIdx.x % m_tiles;
  const int rows = min(kBM, chunk_rows - mt * kBM);   // rows of the tile
  const long long row0 = static_cast<long long>(chunk) * chunk_rows + mt * kBM;
  const int n0 = blockIdx.y * kBN;
  CK_BEGIN();
  CK(operand, kOpX, x, ck::kInput);
  CK(operand, kOpW, w, ck::kInput);
  CK(operand, kOpExpert, chunk_expert, ck::kInput);
  CK(operand, kOpLive, live_rows, ck::kInput);
  CK(operand, kOpOut, out, ck::kOutput);
  CK_IF(t == 0 && live_rows, gread, kOpLive, live_rows, live_rows + chunk, 1,
        1);
  CK_IF(t == 0, gwrite, kOpOut, out, out + row0 * d_out + n0, rows,
        min(kBN, d_out - n0), d_out);
  // rows from `live` on are written as zeros and never loaded
  const int live = live_rows
                       ? max(0, min(rows, live_rows[chunk] - mt * kBM))
                       : rows;
  if (live == 0) {
    for (int i = t; i < rows * kBN; i += kThreads) {
      const int col = n0 + i % kBN;
      if (col < d_out) store1(out + (row0 + i / kBN) * d_out + col, 0.f);
    }
    return;
  }
  const int e = chunk_expert[chunk];
  const TW* we = w + static_cast<long long>(e) * d_in * d_out;
  CK_IF(t == 0, gread, kOpExpert, chunk_expert, chunk_expert + chunk, 1, 1);
  CK_IF(t == 0, gread, kOpX, x, x + row0 * d_in, live, d_in, d_in);
  CK_IF(t == 0, gread, kOpW, w, we + n0, d_in, min(kBN, d_out - n0), d_out);

  // loader roles: x tile 128 rows x 8 k (row t/2, k group (t%2)*4); w tile
  // 8 k x 128 columns (k row t/32, column group (t%32)*4)
  const int xr = t >> 1;
  const int xk = (t & 1) * 4;
  const int wk = t >> 5;
  const int wn = (t & 31) * 4;
  const TX* xp = x + (row0 + xr) * d_in + xk;
  const TW* wp = we + static_cast<long long>(wk) * d_out + n0 + wn;
  const bool x_live = xr < live;
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
    const bool keep = r < live;
    TO* orow = out + (row0 + r) * d_out;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + 64 * h + 4 * tx;
      store4<TO, VEC>(orow + col, keep ? acc[i][4 * h] : 0.f,
                      keep ? acc[i][4 * h + 1] : 0.f,
                      keep ? acc[i][4 * h + 2] : 0.f,
                      keep ? acc[i][4 * h + 3] : 0.f, d_out - col);
    }
  }
}

template <typename TX, typename TW, typename TO>
int launch(const void* x, const void* w, const int* chunk_expert,
           const int* live_rows, void* out, int n_chunks, int chunk_rows,
           int d_in, int d_out, int vec, cudaStream_t stream) {
  const int m_tiles = (chunk_rows + kBM - 1) / kBM;
  const dim3 grid(n_chunks * m_tiles, (d_out + kBN - 1) / kBN);
  CK_LAUNCH("moe_gemm_kernel", stream);
  auto args = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TW*>(w), chunk_expert,
        live_rows, static_cast<TO*>(out), chunk_rows, m_tiles, d_in, d_out);
  };
  if (vec)
    args(moe_gemm_kernel<TX, TW, TO, true>);
  else
    args(moe_gemm_kernel<TX, TW, TO, false>);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TW>
int by_out(int out_bf16, const void* x, const void* w, const int* ce,
           const int* live, void* out, int n_chunks, int chunk_rows,
           int d_in, int d_out, int vec, cudaStream_t s) {
  return out_bf16 ? launch<TX, TW, __nv_bfloat16>(x, w, ce, live, out,
                                                  n_chunks, chunk_rows, d_in,
                                                  d_out, vec, s)
                  : launch<TX, TW, float>(x, w, ce, live, out, n_chunks,
                                          chunk_rows, d_in, d_out, vec, s);
}

int run(const void* x, const void* w, const int* ce, const int* live,
        void* out, int n_chunks, int chunk_rows, int d_in, int d_out,
        int x_bf16, int w_bf16, int out_bf16, int vec, cudaStream_t s) {
  if ((d_out + kBN - 1) / kBN > 65535) return -1;
  using bf = __nv_bfloat16;
  if (x_bf16 && w_bf16)
    return by_out<bf, bf>(out_bf16, x, w, ce, live, out, n_chunks,
                          chunk_rows, d_in, d_out, vec, s);
  if (x_bf16)
    return by_out<bf, float>(out_bf16, x, w, ce, live, out, n_chunks,
                             chunk_rows, d_in, d_out, vec, s);
  if (w_bf16)
    return by_out<float, bf>(out_bf16, x, w, ce, live, out, n_chunks,
                             chunk_rows, d_in, d_out, vec, s);
  return by_out<float, float>(out_bf16, x, w, ce, live, out, n_chunks,
                              chunk_rows, d_in, d_out, vec, s);
}

}  // namespace simt

// ---------------------------------------------------------------------------
// tc: the tensor-core kernel (TMA + wgmma, warp-specialised)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBM = 128;                 // tile rows: two 64-row halves
constexpr int kBN = 128;                 // tile columns: one wgmma N
constexpr int kBK = 64;                  // K step: 128 bytes of bf16
constexpr int kHalf = 64;                // rows of one consumer warpgroup
constexpr int kStages = 6;
constexpr int kThreads = 384;            // producer + two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kBox = 64 * 64 * 2;        // one 64 x 64 bf16 TMA box, 8 KiB
// stage: x rows 0-63, x rows 64-127, w columns 0-63, w columns 64-127
constexpr int kStageBytes = 4 * kBox;
constexpr int kSmemBytes = kStages * kStageBytes + 1024   // 1 KiB: alignment
                           + 2 * kStages * 8;              // the mbarriers

// A (x): K-major, 64 rows of 128 bytes, 8-row groups 1024 bytes apart; the
// leading offset is unused under the swizzle.  A k16 slice starts 32 bytes
// further along the row.
// B (w): MN-major (N contiguous), 8 k-rows of 128 bytes a swizzle atom:
// stride offset 1024 bytes between 8-row k groups, leading offset one box
// (8 KiB) between the 64-column halves of N.  A k16 slice starts 16 rows
// (2048 bytes) further.
constexpr uint32_t kLboA = 16, kSboA = 1024;
constexpr uint32_t kLboB = kBox, kSboB = 1024;

// d (64 x 128 fp32, 64 registers a thread) = A @ B (+ d when accumulate):
// bf16 operands, A K-major, B MN-major (imm-trans-b = 1).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// One output tile: its first buffer row, chunk, first column, rows in the
// chunk (<= 128) and live rows (<= rows).  Producer and consumers derive it
// alike, so they skip the same dead tiles.
struct Tile {
  int row0, chunk, n0, rows, live;
};

__device__ __forceinline__ Tile tile_of(int t, int n_tiles_n, int m_tiles,
                                        int chunk_rows,
                                        const int* __restrict__ live_rows) {
  const int mg = t / n_tiles_n;
  Tile tl;
  tl.n0 = (t - mg * n_tiles_n) * kBN;
  tl.chunk = mg / m_tiles;
  const int mt = mg - tl.chunk * m_tiles;
  tl.rows = min(kBM, chunk_rows - mt * kBM);
  tl.row0 = tl.chunk * chunk_rows + mt * kBM;
  tl.live = live_rows
                ? max(0, min(tl.rows, __ldg(live_rows + tl.chunk) - mt * kBM))
                : tl.rows;
  return tl;
}

template <typename TO>
__global__ void __launch_bounds__(kThreads, 1) moe_gemm_tc(
    const __grid_constant__ CUtensorMap map_x,
    const __grid_constant__ CUtensorMap map_w,
    const int* __restrict__ chunk_expert, const int* __restrict__ live_rows,
    TO* __restrict__ out, int chunk_rows, int m_tiles, int n_tiles_n,
    int n_tiles, int d_in, int d_out) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;      // 1 KiB for the swizzle
  const uint32_t bars = base + kStages * kStageBytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  auto stage = [&](int s, int box) {
    return base + s * kStageBytes + box * kBox;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int n_k = (d_in + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;
  CK_BEGIN();
  CK(operand, kOpExpert, chunk_expert, ck::kInput);
  CK(operand, kOpLive, live_rows, ck::kInput);
  CK(operand, kOpOut, out, ck::kOutput);
  CK(ring, kRingTiles, kStages, ck::kMbarrier);

  if (wg == 0) {
    // producer: one thread keeps the ring full
    if (threadIdx.x != 0) return;
    // weights stream through once; a chunk's x rows are re-read by the
    // blocks of its other N tiles
    uint64_t stream_once, keep;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
                 : "=l"(stream_once));
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
                 : "=l"(keep));
    int s = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const Tile tl = tile_of(t, n_tiles_n, m_tiles, chunk_rows, live_rows);
      CK(pass, t, 0);   // a tile is a pass; the ring runs on across them
      CK_IF(live_rows, gread, kOpLive, live_rows, live_rows + tl.chunk, 1, 1);
      if (tl.live == 0) continue;
      CK(gread, kOpExpert, chunk_expert, chunk_expert + tl.chunk, 1, 1);
      const int e = __ldg(chunk_expert + tl.chunk);
      const bool x_hi = tl.live > kHalf;           // rows 64-127 live
      const bool w_hi = tl.n0 + 64 < d_out;        // columns 64-127 exist
      const uint32_t bytes = kBox * (2 + x_hi + w_hi);
      for (int kb = 0; kb < n_k; ++kb) {
        mbar_wait(empty(s), phase ^ 1);
        mbar_expect_tx(full(s), bytes, CK_TAG(true, kRingTiles, s, 0));
        const int k0 = kb * kBK;
        // a box past d_in (the last k step) or past d_out relies on TMA's
        // zero fill
        tma_2d(stage(s, 0), &map_x, full(s), k0, tl.row0, keep,
               CK_BOX(true, kOpX, 64, 64, 1, ck::kZeroFill));
        if (x_hi)
          tma_2d(stage(s, 1), &map_x, full(s), k0, tl.row0 + kHalf, keep,
                 CK_BOX(true, kOpX, 64, 64, 1, ck::kZeroFill));
        tma_3d(stage(s, 2), &map_w, full(s), tl.n0, k0, e, stream_once,
               CK_BOX(true, kOpW, 64, 64, 1, ck::kZeroFill));
        if (w_hi)
          tma_3d(stage(s, 3), &map_w, full(s), tl.n0 + 64, k0, e,
                 stream_once, CK_BOX(true, kOpW, 64, 64, 1, ck::kZeroFill));
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup 1 rows 0-63 of the tile, warpgroup 2 rows 64-127
  const int half = wg - 1;
  const int ct = threadIdx.x - 128 * wg;
  const int warp = ct / 32;
  const int lane = ct % 32;
  int s = 0;
  uint32_t phase = 0;
  float acc[64];
  float part[64];
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const Tile tl = tile_of(t, n_tiles_n, m_tiles, chunk_rows, live_rows);
    CK_IF(ct == 0, pass, t, wg);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    if (tl.live > 0) {
      const bool mine = tl.live > half * kHalf;   // this half has a live row
      for (int kb = 0; kb < n_k; ++kb) {
        mbar_wait(full(s), phase, CK_TAG(ct == 0, kRingTiles, s, wg));
        CK_IF(ct == 0 && mine, read, kRingTiles, s, wg);
        if (mine) {
          const uint64_t da = smem_desc(stage(s, half), kLboA, kSboA);
          const uint64_t db = smem_desc(stage(s, 2), kLboB, kSboB);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk)
            wgmma_m64n128k16(part, da + ((kk * 32) >> 4),
                             db + ((kk * 16 * 128) >> 4), kk > 0);
          wgmma_commit();
          wgmma_wait0();
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            fence_operand(part[i]);
            acc[i] += part[i];
          }
        }
        __syncwarp();
        if (lane == 0)
          mbar_arrive(empty(s), CK_TAG(ct == 0, kRingTiles, s, wg));
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    // epilogue: fragment (i, j) of m64n128 holds row 16 warp + lane/4 (+8
    // for j >= 2), column 8 i + 2 (lane % 4) (+1 for odd j)
    CK_IF(ct == 0 && half * kHalf < tl.rows, gwrite, kOpOut, out,
          out + static_cast<long long>(tl.row0 + half * kHalf) * d_out + tl.n0,
          min(kHalf, tl.rows - half * kHalf), min(kBN, d_out - tl.n0), d_out);
    const int r_lo = half * kHalf + 16 * warp + lane / 4;
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i) {
      const int col = tl.n0 + 8 * i + 2 * (lane % 4);
      if (col >= d_out) continue;     // d_out % 8 == 0: col + 1 < d_out too
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r_lo + 8 * h;
        if (r >= tl.rows) continue;
        const bool live = r < tl.live;
        store2(out + static_cast<long long>(tl.row0 + r) * d_out + col,
               live ? acc[4 * i + 2 * h] : 0.f,
               live ? acc[4 * i + 2 * h + 1] : 0.f);
      }
    }
  }
}

// A bf16 tensor map of `rank` dims (innermost first), 64 x 64 boxes (x 1
// along a third dim), 128-byte swizzle, zero fill out of bounds.
bool encode(CUtensorMap* map, const void* ptr, int rank,
            const cuuint64_t* dims, const cuuint64_t* strides_bytes) {
  EncodeTiled fn = encode_fn();
  if (!fn) return false;
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(ptr), dims, strides_bytes, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TO>
int launch(const void* x, const void* w, const int* ce, const int* live,
           void* out, int n_chunks, int chunk_rows, int d_in, int d_out,
           int n_experts, cudaStream_t stream) {
  CUtensorMap map_x, map_w;
  const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(d_in),
                                static_cast<cuuint64_t>(n_chunks) *
                                    chunk_rows};
  const cuuint64_t x_strides[1] = {static_cast<cuuint64_t>(d_in) * 2};
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(d_out),
                                static_cast<cuuint64_t>(d_in),
                                static_cast<cuuint64_t>(n_experts)};
  const cuuint64_t w_strides[2] = {
      static_cast<cuuint64_t>(d_out) * 2,
      static_cast<cuuint64_t>(d_in) * d_out * 2};
  if (!encode(&map_x, x, 2, x_dims, x_strides) ||
      !encode(&map_w, w, 3, w_dims, w_strides))
    return -2;
  static int sms = 0;
  static bool attr_set = false;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_gemm_tc<TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int m_tiles = (chunk_rows + kBM - 1) / kBM;
  const int n_tiles_n = (d_out + kBN - 1) / kBN;
  const long long n_tiles =
      static_cast<long long>(n_chunks) * m_tiles * n_tiles_n;
  if (n_tiles > 0x7fffffff) return -1;
  const int grid = static_cast<int>(n_tiles < sms ? n_tiles : sms);
  CK_MAP(kOpX, d_in, static_cast<long long>(n_chunks) * chunk_rows, 1,
         stream);
  CK_MAP(kOpW, d_out, d_in, n_experts, stream);
  CK_LAUNCH("moe_gemm_tc", stream);
  moe_gemm_tc<TO><<<grid, kThreads, kSmemBytes, stream>>>(
      map_x, map_w, ce, live, static_cast<TO*>(out), chunk_rows, m_tiles,
      n_tiles_n, static_cast<int>(n_tiles), d_in, d_out);
  return static_cast<int>(cudaGetLastError());
}

int run(const void* x, const void* w, const int* ce, const int* live,
        void* out, int n_chunks, int chunk_rows, int d_in, int d_out,
        int n_experts, int out_bf16, cudaStream_t s) {
  if (d_in % 8 || d_out % 8 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16 ||
      static_cast<long long>(n_chunks) * chunk_rows > 0x7fffffff)
    return -1;
  return out_bf16 ? launch<__nv_bfloat16>(x, w, ce, live, out, n_chunks,
                                          chunk_rows, d_in, d_out, n_experts,
                                          s)
                  : launch<float>(x, w, ce, live, out, n_chunks, chunk_rows,
                                  d_in, d_out, n_experts, s);
}

}  // namespace tc

}  // namespace

CK_NAMES("op:0:x op:1:w op:2:chunk_expert op:3:live_rows op:4:out "
         "ring:0:tiles")

extern "C" {

// x (n_chunks * chunk_rows, d_in), w (n_experts, d_in, d_out), out
// (n_chunks * chunk_rows, d_out): contiguous row-major; x and w each fp32
// (0) or bf16 (1), out fp32 (0) or bf16 (1); chunk_expert (n_chunks,)
// int32 on the device; live_rows (n_chunks,) int32 on the device or null
// (every row live).  path: 0 the SIMT kernel with scalar loads, 1 the SIMT
// kernel with vector loads (d_in % 4 == 0, d_out % 4 == 0, 16-byte-aligned
// x, w and out), 2 the tensor-core kernel (bf16 x and w, d_in % 8 == 0,
// d_out % 8 == 0, 16-byte-aligned x, w and out).  Returns 0, a cudaError_t
// value, -1 for a call out of the chosen path's range, or -2 when a TMA
// descriptor cannot be made.
int moe_gemm(const void* x, const void* w, const int* chunk_expert,
             const int* live_rows, void* out, int n_chunks, int chunk_rows,
             int d_in, int d_out, int n_experts, int x_bf16, int w_bf16,
             int out_bf16, int path, void* stream) {
  if (n_chunks < 1 || chunk_rows < 1 || d_in < 1 || d_out < 1 ||
      n_experts < 1)
    return -1;
  auto s = static_cast<cudaStream_t>(stream);
  if (path == 2) {
    if (!x_bf16 || !w_bf16) return -1;
    return tc::run(x, w, chunk_expert, live_rows, out, n_chunks, chunk_rows,
                   d_in, d_out, n_experts, out_bf16, s);
  }
  return simt::run(x, w, chunk_expert, live_rows, out, n_chunks, chunk_rows,
                   d_in, d_out, x_bf16, w_bf16, out_bf16, path == 1, s);
}

const char* moe_gemm_error_string(int code) {
  if (code == -1) return "shape out of range";
  if (code == -2) return "cuTensorMapEncodeTiled failed";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
