// Segment-scheduled block-sparse x dense matmul on the tensor cores:
// C = BSR(A) @ B (forward) or C = BSR(A)^T @ B (transpose_lhs), 64 x 64
// blocks, bf16 B, fp32 or bf16 C; fp32 blocks, or int8 / fp8-e4m3
// payloads with per-block or rowwise fp32 scales.  The path the wrapper
// (src/repro_torch/kernels/segment_spmm.py) gives prefill and training
// widths; decode widths and what this kernel does not take run on the
// CUDA-core kernels of segment_spmm.cu.
//
// Replaces the TPU kernel src/repro/kernels/segment_spmm.py::segment_spmm
// for those calls.  Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a library with the plain C interface at the bottom of this file,
// loaded from Python with ctypes (src/repro_torch/kernels/build.py).
//
// Numerics.  Every fp32 value a splits exactly into three bf16 values,
// hi = bf16(a), mid = bf16(a - hi), lo = bf16(a - hi - mid): a - hi has at
// most 16 significant bits and a - hi - mid at most 8, each residual is
// exact in fp32, and bf16 has fp32's exponent range.  A bf16 x bf16
// product is exact in fp32, so hi.B + mid.B + lo.B has fp32 products and
// differs from an fp32 product only in the order of the sum, which the
// port's 1e-5 tolerance already allows.  int8 and e4m3 values are exact in
// bf16, so a per-block-scaled payload needs one tile (hi) and no split; a
// rowwise payload is dequantized (payload x its row's scale, one fp32
// rounding, as repro does) and then split.  Each item's product is summed
// in the tensor cores into a fresh fp32 fragment (lo first, then mid, then
// hi: 12 (or 4) wgmma of depth 16), then promoted: added to the running
// fp32 accumulator on the CUDA cores, times the per-block scale where
// there is one (both roundings kept, no fused multiply-add, as
// contrib * scale is added in repro's kernel).  A long sum in the tensor
// cores alone misses fp32 parity (found on moe_gemm over K = 8192); the
// per-item promotion keeps each one 64 deep.
//
// Work decomposition.  One thread block per (N tile, owner run): the
// planner keeps every output block row's items (folded continuations
// included) contiguous in one run, so the block walks them in schedule
// order and applies the plan's flags to its register accumulator as
// repro's kernel applies them to its VMEM tile: zero at seg_start, reload
// from C at accum_prev (the same thread stored that element at the
// segment's earlier seg_write), add the item's product when valid, store
// at seg_write.  N tiles are the fast grid axis, so the tiles of one run
// share its A tiles in L2.
//
// Block layout (one block an SM): a producer warpgroup and WGS consumer
// warpgroups of 128 columns each, WGS = 2 (a 256-column N tile) above N =
// 128 and 1 at or below it, where the smaller B slice leaves room for a
// deeper ring (4 stages for fp32 tiles instead of 3): at those widths the
// ring's depth, not the tensor cores, sets the pace.
// - Warpgroup 0 produces.  Thread 0 keeps a ring of stages loaded up to
//   kStages - 1 valid items ahead: the item's stored tile (16 KB fp32, 4
//   KB payload) and rowwise scales by bulk copy, its B slice (64 k x N
//   tile bf16) by TMA, all completing on the stage's "full" mbarrier.  B
//   comes k-contiguous (the sparse FFN's x.T and the backward pass's dy:
//   one box, K-major) or N-contiguous (h.T made contiguous: 64 x 64
//   boxes, MN-major); the ragged N edge is zero-filled by TMA, so B is
//   never padded.  All 128 threads then split the stored tile into its
//   bf16 tiles, written as wgmma's K-major operand under the 128-byte
//   swizzle (forward: M = stored rows; transpose_lhs: M = stored columns,
//   so the splitter writes the tile transposed and both modes share one
//   operand layout), fence them for the async proxy and arrive on the
//   stage's "ready" mbarrier.
// - The consumer warpgroups each take 128 columns of the tile (wgmma
//   m64n128k16, bf16 -> fp32; B through its transpose bit) and release
//   the stage on its "empty" mbarrier.  They share one split A tile, so a
//   tile is staged and split once per N tile.  A warpgroup whose columns
//   all lie past N only waits and releases.
// Pad items (valid == 0) carry no flags and use no stage.  A wait of ~9 s
// traps, so a pipeline fault fails the launch instead of hanging the card.
//
// Bound.  At the training width (N = 2048) one granite-3-8b FFN projection
// is 3200 valid items of 2 x 64 x 64 x 2048 operations: 53.7 GFLOP, 3 x
// 53.7 on the split, 0.163 ms at the 989 TFLOP/s bf16 tensor-core peak
// (0.054 ms for a per-block payload's one pass); the fp32 CUDA-core bound
// of the same product is 0.80 ms.  B (16.8 MB bf16) and C are read from L2
// by every run; each A tile is read once per N tile, from L2 after the
// first.  So L2 traffic binds this dataflow before the tensor cores do:
// each item moves a 32 KB B slice and a 16 KB tile into the SM, ~1.26 GB a
// projection at N = 2048.
#include <cuda.h>          // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

enum Payload { kF32 = 0, kI8 = 1, kF8 = 2 };
enum ScaleMode { kNone = 0, kBlock = 1, kRow = 2 };

constexpr int kBM = 64;                  // block (stored tile) size
constexpr int kWgN = 128;                // columns of one consumer warpgroup
constexpr int kProducerWarps = 4;
constexpr int kTile = kBM * kBM * 2;     // one bf16 64 x 64 tile, 8 KiB
constexpr int kBox = 64 * 64 * 2;        // one 64 x 64 bf16 TMA box
// the checked build's operands and ring (check.cuh)
enum CkOp {
  kOpA = 0, kOpScales, kOpB, kOpC, kOpSlot, kOpM, kOpK, kOpStart, kOpWrite,
  kOpPrev, kOpValid, kOpRuns
};
constexpr int kRingB = 0;   // a stage: B's slice, the stored tile, scales
constexpr int kSmemMax = 232448;         // opt-in shared memory of a block
constexpr int kMaxStages = 6;

// A block of WGS consumer warpgroups (1 for N <= 128, else 2) and one
// producer warpgroup; one ring stage holds, in 1 KiB-aligned pieces, B,
// the split tiles (hi, mid, lo), the stored tile as it came and its
// rowwise scales, and the ring is as deep as the shared memory allows
// (3 stages for fp32 tiles and two consumer warpgroups, 4 with one).
template <int PAY, int SCALE, int WGS>
struct Layout {
  static constexpr int kBN = kWgN * WGS;          // N tile
  static constexpr int kThreads = 128 * (1 + WGS);
  static constexpr int kConsumerWarps = 4 * WGS;
  static constexpr int kBBytes = kBN * kBM * 2;   // one B slice
  static constexpr int kParts = (PAY == kF32 || SCALE == kRow) ? 3 : 1;
  static constexpr int kSplit = kBBytes;
  static constexpr int kRaw = kSplit + kParts * kTile;
  static constexpr int kRawBytes = PAY == kF32 ? kBM * kBM * 4 : kBM * kBM;
  static constexpr int kScales = kRaw + kRawBytes;
  static constexpr int kScaleBytes = SCALE == kRow ? kBM * 4 : 0;
  static constexpr int kStage = (kScales + kScaleBytes + 1023) / 1024 * 1024;
  static constexpr int kFit = (kSmemMax - 1024 - 24 * kMaxStages) / kStage;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmem = kStages * kStage + 1024   // 1 KiB: alignment
                               + 3 * kStages * 8;        // the mbarriers
  static_assert(kStages >= 3, "ring too shallow");
};

#define SEGMENT_SPMM_WGMMA_ARGS                                            \
  "{"                                                                      \
  "%0, %1, %2, %3, %4, %5, %6, %7, "                                       \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                                 \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                               \
  "%24, %25, %26, %27, %28, %29, %30, %31, "                               \
  "%32, %33, %34, %35, %36, %37, %38, %39, "                               \
  "%40, %41, %42, %43, %44, %45, %46, %47, "                               \
  "%48, %49, %50, %51, %52, %53, %54, %55, "                               \
  "%56, %57, %58, %59, %60, %61, %62, %63"                                 \
  "}, %64, %65, p, 1, 1, 0, "
#define SEGMENT_SPMM_WGMMA_OPERANDS                                        \
  : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
    "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),            \
    "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),       \
    "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),       \
    "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
    "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),       \
    "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),       \
    "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),       \
    "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),       \
    "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),       \
    "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),       \
    "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),       \
    "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                     \
  : "l"(desc_a), "l"(desc_b), "r"(accumulate)

// d (64 x 128 fp32, 64 registers a thread) = A @ B (+ d when accumulate):
// bf16 operands, A K-major; B K-major (KB) or MN-major (transpose bit).
template <bool KB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int accumulate) {
  if constexpr (KB) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        SEGMENT_SPMM_WGMMA_ARGS "0;\n"
        "}\n" SEGMENT_SPMM_WGMMA_OPERANDS);
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        SEGMENT_SPMM_WGMMA_ARGS "1;\n"
        "}\n" SEGMENT_SPMM_WGMMA_OPERANDS);
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// One payload byte to fp32 (exact for both payload types).
template <int PAY>
__device__ __forceinline__ float byte_to_f32(unsigned char x) {
  if constexpr (PAY == kI8) {
    return static_cast<float>(static_cast<signed char>(x));
  } else {
    return __half2float(
        __half(__nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(x),
                                       __NV_E4M3)));
  }
}

// The stored tile of one item, as it came (raw: fp32 or payload bytes,
// row-major 64 x 64; rowwise scales sc), to its bf16 tiles in `dst` (part
// p at dst + p * kTile; 0 = hi, 1 = mid, 2 = lo): wgmma's K-major operand,
// 64 rows of 128 bytes, 16-byte chunk c of row m at chunk c ^ (m % 8).
// 128 threads, four 8-value chunks each.
template <bool TRANS, int PAY, int SCALE>
__device__ __forceinline__ void split_tile(const uint8_t* raw,
                                           const float* sc, uint8_t* dst,
                                           int t) {
  constexpr int kParts = Layout<PAY, SCALE, 1>::kParts;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ci = t + 128 * i;
    int row, ch;
    float v[8];
    if constexpr (!TRANS) {
      // M = stored row, K = stored columns 8 ch .. 8 ch + 7
      row = ci >> 3;
      ch = ci & 7;
      if constexpr (PAY == kF32) {
        const float4* p =
            reinterpret_cast<const float4*>(raw + (row * kBM + 8 * ch) * 4);
        const float4 x0 = p[0], x1 = p[1];
        v[0] = x0.x; v[1] = x0.y; v[2] = x0.z; v[3] = x0.w;
        v[4] = x1.x; v[5] = x1.y; v[6] = x1.z; v[7] = x1.w;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = byte_to_f32<PAY>(raw[row * kBM + 8 * ch + j]);
      }
      if constexpr (SCALE == kRow) {
        const float s = sc[row];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = __fmul_rn(v[j], s);
      }
    } else {
      // M = stored column, K = stored rows 8 ch .. 8 ch + 7; neighbouring
      // lanes read neighbouring columns of one stored row
      row = ci & 63;
      ch = ci >> 6;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = 8 * ch + j;
        if constexpr (PAY == kF32) {
          v[j] = reinterpret_cast<const float*>(raw)[r * kBM + row];
        } else {
          v[j] = byte_to_f32<PAY>(raw[r * kBM + row]);
        }
        if constexpr (SCALE == kRow) v[j] = __fmul_rn(v[j], sc[r]);
      }
    }
    const int off = row * 128 + ((ch ^ (row & 7)) << 4);
    // two values a conversion (cvt.rn.bf16x2.f32), the first in the low
    // half, as wgmma reads them
    uint4 h, m, l;
    unsigned* hw = reinterpret_cast<unsigned*>(&h);
    unsigned* mw = reinterpret_cast<unsigned*>(&m);
    unsigned* lw = reinterpret_cast<unsigned*>(&l);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
      hw[j] = bits(h2);
      if constexpr (kParts == 3) {
        const float2 hf = __bfloat1622float2(h2);
        const float r0 = __fsub_rn(v[2 * j], hf.x);
        const float r1 = __fsub_rn(v[2 * j + 1], hf.y);
        const __nv_bfloat162 m2 = __floats2bfloat162_rn(r0, r1);
        const float2 mf = __bfloat1622float2(m2);
        mw[j] = bits(m2);
        lw[j] = bits(__floats2bfloat162_rn(__fsub_rn(r0, mf.x),
                                           __fsub_rn(r1, mf.y)));
      }
    }
    *reinterpret_cast<uint4*>(dst + off) = h;
    if constexpr (kParts == 3) {
      *reinterpret_cast<uint4*>(dst + kTile + off) = m;
      *reinterpret_cast<uint4*>(dst + 2 * kTile + off) = l;
    }
  }
}

template <bool TRANS, int PAY, int SCALE, bool KB, int WGS, typename TO>
__global__ void __launch_bounds__(Layout<PAY, SCALE, WGS>::kThreads, 1)
    segment_spmm_tc_kernel(
    const __grid_constant__ CUtensorMap map_b, const void* __restrict__ a,
    const float* __restrict__ a_scales, TO* c,
    const int* __restrict__ slot_idx, const int* __restrict__ m_idx,
    const int* __restrict__ k_idx, const int* __restrict__ seg_start,
    const int* __restrict__ seg_write, const int* __restrict__ accum_prev,
    const int* __restrict__ valid, const int* __restrict__ run_off, int n) {
  using Lay = Layout<PAY, SCALE, WGS>;
  constexpr int kStages = Lay::kStages;
  constexpr int kBN = Lay::kBN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_u32 = smem_u32(smem_raw);
  const uint32_t base = (raw_u32 + 1023) & ~1023u;   // 1 KiB for the swizzle
  uint8_t* const gbase = smem_raw + (base - raw_u32);
  const uint32_t bars = base + kStages * Lay::kStage;
  auto full = [&](int s) { return bars + 8 * s; };
  auto ready = [&](int s) { return bars + 8 * (kStages + s); };
  auto empty = [&](int s) { return bars + 8 * (2 * kStages + s); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(ready(s), kProducerWarps);
      mbar_init(empty(s), Lay::kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int lo = run_off[blockIdx.y];
  const int hi = run_off[blockIdx.y + 1];
  const int n0 = blockIdx.x * kBN;
  const int wg = threadIdx.x / 128;
  CK_BEGIN();
  CK(operand, kOpA, static_cast<const unsigned char*>(a), ck::kInput);
  CK(operand, kOpScales, a_scales, ck::kInput);
  CK(operand, kOpC, c, ck::kOutput);
  CK(operand_each, kOpSlot, ck::kInput, slot_idx, m_idx, k_idx, seg_start,
     seg_write, accum_prev, valid);
  CK(operand, kOpRuns, run_off, ck::kInput);
  CK(ring, kRingB, kStages, ck::kMbarrier);
  CK_IF(threadIdx.x == 0, gread, kOpRuns, run_off, run_off + blockIdx.y, 1,
        2);
  CK_IF(threadIdx.x == 0, gread, kOpM, m_idx, m_idx + lo, 1, 1);
  CK_IF(threadIdx.x == 0, gread_each, kOpSlot, lo, hi - lo, slot_idx, m_idx,
        k_idx, seg_start, seg_write, accum_prev, valid);

  if (wg == 0) {
    // producer: thread 0 loads kStages - 1 valid items ahead; all 128
    // split
    const int t = threadIdx.x;
    // MN-major B comes in 64-column boxes: only those that start inside N
    const int boxes = KB ? 0 : min(kBN / 64, (n - n0 + 63) / 64);
    const uint32_t bytes = Lay::kRawBytes + Lay::kScaleBytes +
                           (KB ? Lay::kBBytes : boxes * kBox);
    int ld = lo;       // thread 0: the next item to look at for a load
    int n_ld = 0;      // thread 0: valid items loaded so far
    auto load_next = [&]() {
      while (ld < hi && !valid[ld]) ++ld;
      if (ld >= hi) return;
      const int s = n_ld % kStages;
      mbar_wait(empty(s), ((n_ld / kStages) & 1) ^ 1);
      const uint32_t st = base + s * Lay::kStage;
      const long long slot = slot_idx[ld];
      mbar_expect_tx(full(s), bytes, CK_TAG(true, kRingB, s, 0));
      bulk_copy(st + Lay::kRaw,
                static_cast<const uint8_t*>(a) + slot * Lay::kRawBytes,
                Lay::kRawBytes, full(s), CK_COPY(true, kOpA, a, 0));
      if constexpr (SCALE == kRow)
        bulk_copy(st + Lay::kScales, a_scales + slot * kBM, Lay::kScaleBytes,
                  full(s), CK_COPY(true, kOpScales, a_scales, 0));
      const int k0 = k_idx[ld] * kBM;
      // a slice past N relies on TMA's zero fill: its columns are never
      // stored
      if constexpr (KB) {
        tma_2d(st, &map_b, full(s), k0, n0,
               CK_BOX(true, kOpB, 64, kBN, 1, ck::kZeroFill));
      } else {
        for (int bx = 0; bx < boxes; ++bx)
          tma_2d(st + bx * kBox, &map_b, full(s), n0 + 64 * bx, k0,
                 CK_BOX(true, kOpB, 64, 64, 1, ck::kZeroFill));
      }
      ++ld;
      ++n_ld;
    };
    if (t == 0)
      for (int i = 0; i < kStages - 1; ++i) load_next();
    int q = 0;
    for (int it = lo; it < hi; ++it) {
      if (!valid[it]) continue;
      const int s = q % kStages;
      mbar_wait(full(s), (q / kStages) & 1, CK_TAG(t == 0, kRingB, s, 0));
      CK_IF(t == 0, read, kRingB, s, 0);
      uint8_t* st = gbase + s * Lay::kStage;
      split_tile<TRANS, PAY, SCALE>(
          st + Lay::kRaw, reinterpret_cast<const float*>(st + Lay::kScales),
          st + Lay::kSplit, t);
      // the split tiles are read by wgmma, through the async proxy
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncwarp();
      // the split tiles are the producer warpgroup's hand-off: its read of
      // the stage ends here
      if ((t & 31) == 0) mbar_arrive(ready(s), CK_TAG(t == 0, kRingB, s, 0));
      if (t == 0) load_next();
      ++q;
    }
    return;
  }

  // consumers: warpgroup 1 columns n0 .. n0 + 127, warpgroup 2 the next 128
  const int cw = wg - 1;
  const int ct = threadIdx.x - 128 * wg;
  const int warp = ct / 32;
  const int lane = ct % 32;
  const int nc0 = n0 + kWgN * cw;
  const bool mine = nc0 < n;
  const long long row0 = static_cast<long long>(m_idx[lo]) * kBM;
  // fragment (i, j) of m64n128 (register 4 i + j) holds row 16 warp +
  // lane / 4 (+ 8 for j >= 2), column 8 i + 2 (lane % 4) (+ 1 for odd j)
  const int r_lo = 16 * warp + lane / 4;
  const int c_lo = nc0 + 2 * (lane % 4);
  const bool pairs = (n % 2) == 0;
  float acc[64];
  float part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  int q = 0;
  for (int it = lo; it < hi; ++it) {
    if (seg_start[it]) {
      if (accum_prev[it] && mine) {
        CK_IF(ct == 0, gread, kOpC, c, c + row0 * n + nc0, kBM,
              min(kWgN, n - nc0), n);
#pragma unroll
        for (int i = 0; i < 16; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = c_lo + 8 * i + (j & 1);
            const long long r = row0 + r_lo + 8 * (j >> 1);
            acc[4 * i + j] = col < n ? to_f32(c[r * n + col]) : 0.f;
          }
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      }
    }
    if (valid[it]) {
      const int s = q % kStages;
      const uint32_t ph = (q / kStages) & 1;
      mbar_wait(full(s), ph, CK_TAG(ct == 0, kRingB, s, wg));
      mbar_wait(ready(s), ph);
      CK_IF(ct == 0 && mine, read, kRingB, s, wg);
      if (mine) {
        const uint32_t st = base + s * Lay::kStage;
        const uint32_t bw = st + cw * (kWgN * kBM * 2);   // its columns
        wgmma_fence();
#pragma unroll
        for (int p = Lay::kParts - 1; p >= 0; --p) {   // lo, mid, hi
          const uint32_t at = st + Lay::kSplit + p * kTile;
#pragma unroll
          for (int kk = 0; kk < kBM / 16; ++kk) {
            const uint64_t da = smem_desc(at + kk * 32, 16, 1024);
            // K-major B: 128 rows of 128 bytes, a k16 slice 32 bytes on;
            // MN-major: 8-row k groups 1 KiB apart, the two 64-column boxes
            // 8 KiB apart, a k16 slice 16 rows (2 KiB) on
            const uint64_t db = KB ? smem_desc(bw + kk * 32, 16, 1024)
                                   : smem_desc(bw + kk * 2048, kBox, 1024);
            wgmma_m64n128k16<KB>(part, da, db,
                                 p != Lay::kParts - 1 || kk > 0);
          }
        }
        wgmma_commit();
        wgmma_wait0();
        if constexpr (SCALE == kBlock) {
          CK_IF(ct == 0, gread, kOpScales, a_scales, a_scales + slot_idx[it],
                1, 1);
          const float sb = a_scales[slot_idx[it]];
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            fence_operand(part[i]);
            acc[i] = __fadd_rn(acc[i], __fmul_rn(part[i], sb));
          }
        } else {
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            fence_operand(part[i]);
            acc[i] = __fadd_rn(acc[i], part[i]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s), CK_TAG(ct == 0, kRingB, s, wg));
      ++q;
    }
    CK_IF(ct == 0 && seg_write[it] && mine, gwrite, kOpC, c,
          c + row0 * n + nc0, kBM, min(kWgN, n - nc0), n);
    if (seg_write[it] && mine) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int col = c_lo + 8 * i;
        if (col >= n) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          TO* p = c + (row0 + r_lo + 8 * h) * n + col;
          const float v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
          if (pairs && col + 1 < n) {
            store2(p, v0, v1);
          } else {
            store1(p, v0);
            if (col + 1 < n) store1(p + 1, v1);
          }
        }
      }
    }
  }
}

// A 2-D bf16 tensor map (innermost dim first), 128-byte swizzle, zero
// fill out of bounds.
bool encode(CUtensorMap* map, const void* ptr, cuuint64_t inner,
            cuuint64_t outer, cuuint64_t stride_bytes, cuuint32_t box_inner,
            cuuint32_t box_outer) {
  EncodeTiled fn = encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {stride_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  const void* a;
  const float* a_scales;
  const void* b;
  void* c;
  const int* slot_idx;
  const int* m_idx;
  const int* k_idx;
  const int* seg_start;
  const int* seg_write;
  const int* accum_prev;
  const int* valid;
  const int* run_off;
  int n_runs;
  int k_dim;
  int n;
  long long sbk;
  long long sbn;
  cudaStream_t stream;
};

template <bool TRANS, int PAY, int SCALE, bool KB, int WGS, typename TO>
int launch(const Args& x) {
  using Lay = Layout<PAY, SCALE, WGS>;
  constexpr int kBN = Lay::kBN;
  CUtensorMap map;
  const bool ok =
      KB ? encode(&map, x.b, static_cast<cuuint64_t>(x.k_dim),
                  static_cast<cuuint64_t>(x.n),
                  static_cast<cuuint64_t>(x.sbn) * 2, 64, kBN)
         : encode(&map, x.b, static_cast<cuuint64_t>(x.n),
                  static_cast<cuuint64_t>(x.k_dim),
                  static_cast<cuuint64_t>(x.sbk) * 2, 64, 64);
  if (!ok) return -2;
  auto kernel = segment_spmm_tc_kernel<TRANS, PAY, SCALE, KB, WGS, TO>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid((x.n + kBN - 1) / kBN, x.n_runs);
  if (KB) {
    CK_MAP(kOpB, x.k_dim, x.n, 1, x.stream);
  } else {
    CK_MAP(kOpB, x.n, x.k_dim, 1, x.stream);
  }
  CK_LAUNCH("segment_spmm_tc_kernel", x.stream);
  kernel<<<grid, Lay::kThreads, Lay::kSmem, x.stream>>>(
      map, x.a, x.a_scales, static_cast<TO*>(x.c), x.slot_idx, x.m_idx,
      x.k_idx, x.seg_start, x.seg_write, x.accum_prev, x.valid, x.run_off,
      x.n);
  return static_cast<int>(cudaGetLastError());
}

template <bool TRANS, int PAY, int SCALE, int WGS>
int by_layout(int kb, int c_bf16, const Args& x) {
  using bf16 = __nv_bfloat16;
  if (kb)
    return c_bf16 ? launch<TRANS, PAY, SCALE, true, WGS, bf16>(x)
                  : launch<TRANS, PAY, SCALE, true, WGS, float>(x);
  return c_bf16 ? launch<TRANS, PAY, SCALE, false, WGS, bf16>(x)
                : launch<TRANS, PAY, SCALE, false, WGS, float>(x);
}

// one consumer warpgroup (and a deeper ring) where N fits its 128 columns
template <bool TRANS, int PAY, int SCALE>
int by_width(int kb, int c_bf16, const Args& x) {
  return x.n <= kWgN ? by_layout<TRANS, PAY, SCALE, 1>(kb, c_bf16, x)
                     : by_layout<TRANS, PAY, SCALE, 2>(kb, c_bf16, x);
}

template <bool TRANS>
int by_payload(int payload, int scale_mode, int kb, int c_bf16,
               const Args& x) {
  if (payload == kF32 && scale_mode == kNone)
    return by_width<TRANS, kF32, kNone>(kb, c_bf16, x);
  if (payload == kI8 && scale_mode == kBlock)
    return by_width<TRANS, kI8, kBlock>(kb, c_bf16, x);
  if (payload == kI8 && scale_mode == kRow)
    return by_width<TRANS, kI8, kRow>(kb, c_bf16, x);
  if (payload == kF8 && scale_mode == kBlock)
    return by_width<TRANS, kF8, kBlock>(kb, c_bf16, x);
  if (payload == kF8 && scale_mode == kRow)
    return by_width<TRANS, kF8, kRow>(kb, c_bf16, x);
  return -1;
}

// the shared memory of the launch by_width makes at width n
template <int PAY, int SCALE>
long long smem(int n) {
  return n <= kWgN ? Layout<PAY, SCALE, 1>::kSmem
                   : Layout<PAY, SCALE, 2>::kSmem;
}

}  // namespace

CK_NAMES("op:0:a op:1:a_scales op:2:b op:3:c op:4:slot_idx op:5:m_idx "
         "op:6:k_idx op:7:seg_start op:8:seg_write op:9:accum_prev "
         "op:10:valid op:11:runs ring:0:stages")

extern "C" {

// C[(grid_m*64), n] (row-major, fp32 or bf16) = BSR(A) @ B, or BSR(A)^T @ B
// when trans != 0, under the plan's lane-major schedule, on the tensor
// cores.  A: (n_blocks, 64, 64), contiguous, 16-byte aligned, in the
// forward storage order in both modes; payload 0 = fp32, 1 = int8, 2 =
// fp8-e4m3.  a_scales: fp32, 16-byte aligned, one per block (scale_mode
// 1) or one per block row, (n_blocks, 64) (scale_mode 2); null with
// scale_mode 0, which goes with fp32 blocks only.  B: (k_dim, n) bf16 at
// B[k * sbk + j * sbn] with sbk == 1 (k-contiguous) or sbn == 1
// (N-contiguous), the other stride a multiple of 8 and the base 16-byte
// aligned.  run_off: n_runs + 1 offsets into the schedule arrays.
// Returns 0, a cudaError_t value, -1 for a call out of range, or -2 when
// the TMA descriptor cannot be made.
int segment_spmm_tc(const void* a, const float* a_scales, const void* b,
                    void* c, const int* slot_idx, const int* m_idx,
                    const int* k_idx, const int* seg_start,
                    const int* seg_write, const int* accum_prev,
                    const int* valid, const int* run_off, int n_runs,
                    int k_dim, int n, long long sbk, long long sbn,
                    int trans, int payload, int scale_mode, int c_bf16,
                    void* stream) {
  const int kb = sbk == 1;
  if (n_runs < 1 || n_runs > 65535 || n < 1 || k_dim < kBM ||
      k_dim % kBM || reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16 ||
      reinterpret_cast<uintptr_t>(a_scales) % 16 ||
      (kb ? sbn % 8 : (sbn != 1 || sbk % 8)))
    return -1;
  const Args x{a, a_scales, b, c, slot_idx, m_idx, k_idx, seg_start,
               seg_write, accum_prev, valid, run_off, n_runs, k_dim, n, sbk,
               sbn, static_cast<cudaStream_t>(stream)};
  return trans ? by_payload<true>(payload, scale_mode, kb, c_bf16, x)
               : by_payload<false>(payload, scale_mode, kb, c_bf16, x);
}

// Bytes of dynamic shared memory a segment_spmm_tc launch at width n asks
// for (one consumer warpgroup up to 128 columns, two above), by payload and
// scale mode; -1 for a call the launcher refuses.  No launch.
long long segment_spmm_tc_smem_bytes(int n, int payload, int scale_mode) {
  if (payload == kF32 && scale_mode == kNone) return smem<kF32, kNone>(n);
  if (payload == kI8 && scale_mode == kBlock) return smem<kI8, kBlock>(n);
  if (payload == kI8 && scale_mode == kRow) return smem<kI8, kRow>(n);
  if (payload == kF8 && scale_mode == kBlock) return smem<kF8, kBlock>(n);
  if (payload == kF8 && scale_mode == kRow) return smem<kF8, kRow>(n);
  return -1;
}

const char* segment_spmm_tc_error_string(int code) {
  if (code == -1) return "call out of the tensor-core path's range";
  if (code == -2) return "cuTensorMapEncodeTiled failed";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
