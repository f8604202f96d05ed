// Segment-scheduled block-sparse x block-sparse matmul on the tensor cores
// (the numeric SpGEMM phase): the C blocks of BSR(A) @ BSR(B) at the
// symbolic pattern, 64 x 64 tiles on both sides; fp32 tiles, or int8 /
// fp8-e4m3 payloads with per-block or rowwise fp32 scales on both operands;
// fp32 or bf16 C.  The "tc" path of the wrapper
// (src/repro_torch/kernels/segment_spgemm.py); 32 x 32 and non-square tiles
// run on the CUDA-core kernel of segment_spgemm.cu ("simt").
//
// Replaces the TPU kernel src/repro/kernels/segment_spgemm.py::
// segment_spgemm for those calls.  Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a library with the plain C interface at the bottom of this file,
// loaded from Python with ctypes (src/repro_torch/kernels/build.py).
//
// Numerics.  wgmma bf16 x bf16 -> fp32.  An fp32 tile splits exactly into
// bf16 hi + mid + lo (split_bf16x3 in segment_spmm.py; the SpMM tensor-core
// kernel does the same), and of the nine products of the parts the six
// with part indices i + j <= 2 are kept, smallest first (every dropped term
// is below 2^-24 of the product, as on flash_attention's tc path).  int8
// and e4m3 values are exact in bf16, so a per-block-scaled item takes one
// pass.  A rowwise item takes three: A's row scales act on C's rows and
// come out of the product, so A stays an exact payload tile (one part) and
// its scales multiply the item's product row by row; B's row scales act on
// the contraction axis, so B is dequantized (payload x its row's scale, one
// fp32 rounding, as repro does) and split.  Each item is summed in the
// tensor cores into a fresh fp32 fragment (4 k16 steps a pass) and then
// promoted on the CUDA cores: acc += part (fp32), acc += part * a_row_scale
// (rowwise), acc += (part * a_scale) * b_scale (per block, the CUDA-core
// kernel's order), each rounding kept (no fused multiply-add).  Payload
// bytes become bf16 four at a time (int8: byte_perm into 2^23 + b, one
// subtraction; fp8: cvt of e4m3x2 pairs), never one byte load at a time.
//
// Work decomposition.  A host-built work table (work_table in the
// wrapper, made once per plan and kept on the device beside run_offsets)
// puts the owner runs (one C block each) in Z-order over C and lists each
// run's items in schedule order, one row of ints per item that carries
// all the item needs: A tile, B tile, C block and flags.  So each C block
// follows its flags as on the TPU: zero at seg_start, reload from C at
// accum_prev, add the item's product when valid, store at seg_write (no
// float atomics: a C block lives in one worker).
//
// Block layout: persistent, one block an SM, with two (fp32), four
// (per-block payloads) or three (rowwise) independent pipelines
// ("workers").  A pipeline is one consumer warpgroup and one producer
// thread (lane 0 of a warp after the consumers).  The producer takes the
// next run from a counter the wrapper zeroes for each launch, so the runs
// in flight on the whole card are neighbours on the Z-order curve: a
// compact patch of C whose A and B tiles stay in L2 (the walk that shares
// tile loads).  It passes each of the run's rows to the consumer through
// a ring of rows in shared memory and bulk-copies each valid item's A and
// B tiles (and B's rowwise scales), raw as stored, into a ring of
// single-tile slots that stays full across run boundaries (4 slots for
// fp32 tiles, 8 for payloads).
// The consumer splits the two tiles into bf16 tiles in shared memory
// (wgmma's 128-byte swizzle: A K-major, B MN-major through the transpose
// bit), releases their slots, runs the passes (m64n64k16) into a fresh
// fragment and promotes it into the C block's accumulator.  The pipelines
// of one SM overlap one another's splits, waits and wgmma.  C is stored
// with st.global.cs, streaming past L2.  A wait of ~9 s traps, so a
// pipeline fault fails the launch instead of hanging the card.
//
// Bytes and bounds.  chip_smoke.py prints, per path, the bytes a call
// moves into the SMs: each valid item's A and B tiles (and 256 bytes of
// rowwise scales), each C block written at seg_write and read at
// accum_prev, the table's rows.  At granite-3-8b's FFN shapes (64 x 64
// tiles at 25 % density) that is 5.81 GB for W_up @ W_down in fp32
// (157,631 items, 39,322 C blocks) and 1.72 GB for W_down @ W_up (50,311
// items); 1.94 GB for a 1-byte payload.  Their 105 MB of fp32 tiles do not
// fit the 50 MB L2, which the Z-order walk answers.  Staging one A tile for
// the items of two runs of a C row (measured: groups of 2 runs) saves only
// 5 % of the bytes at 25 % density and ran no faster, so each item loads
// its own pair.  The tensor cores' bound is 2 x 64^3 x passes operations
// an item at 989 TFLOP/s: 0.50 ms (W_up @ W_down, six passes), 0.08 ms (a
// per-block payload).  Shared memory binds fp32 first: an item moves ~208
// KB through it (the bulk copies, the split's reads and writes, 24 wgmma
// of 4 KB), ~1,600 cycles at 128 bytes a cycle.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

enum Payload { kF32 = 0, kI8 = 1, kF8 = 2 };
enum ScaleMode { kNone = 0, kBlock = 1, kRow = 2 };

constexpr int kT = 64;                   // tile size
constexpr int kTile = kT * kT * 2;       // one bf16 64 x 64 tile, 8 KiB
constexpr int kSmemMax = 232448;         // opt-in shared memory of a block
constexpr int kMaxStages = 8;
constexpr int kMaxDevices = 64;
// a work-table row's flags
constexpr int kStart = 2, kPrev = 4, kWrite = 8;   // 1 (valid) is a_tile >= 0

// Pipelines (workers) a block: two for fp32 tiles, where shared memory
// holds no more; for 1-byte payloads, whose items are shorter, as many as
// the registers allow (more items in flight hide more latency): four per
// block (96 registers a thread), three rowwise (128).  Each pipeline's shared
// memory, in 1 KiB-aligned pieces: A's bf16 parts, B's bf16 parts, then a
// ring of raw slots (one stored tile each, with its rowwise scales for a B
// tile).  Then each pipeline's metadata: the mbarriers of its tile ring
// and of its row ring, and the row ring (kRows work-table rows).
constexpr int kRows = 16;                // depth of a pipeline's row ring
// a work-table row: A tile (-1 when the item is not valid), item, B tile,
// C block, flags
constexpr int kRow5 = 5;
constexpr int kMeta = (2 * kMaxStages + 2 * kRows) * 8 + kRows * kRow5 * 4;
// the checked build's operands (check.cuh); pipeline p's tile ring is ring
// 2 p, its row ring 2 p + 1; agent 0 is its producer, 1 its consumer
enum CkOp {
  kOpA = 0, kOpB, kOpC, kOpAScales, kOpBScales, kOpRunSteps, kOpSteps,
  kOpNext
};

template <int PAY, int SCALE>
struct Layout {
  static constexpr int kPipes = PAY == kF32 ? 2 : SCALE == kBlock ? 4 : 3;
  static constexpr int kThreads = 160 * kPipes;
  static constexpr int kAParts = PAY == kF32 ? 3 : 1;
  static constexpr int kBParts = (PAY == kF32 || SCALE == kRow) ? 3 : 1;
  static constexpr int kPasses = PAY == kF32 ? 6 : (SCALE == kRow ? 3 : 1);
  static constexpr int kRawBytes = PAY == kF32 ? kT * kT * 4 : kT * kT;
  static constexpr int kScaleBytes = SCALE == kRow ? kT * 4 : 0;
  static constexpr int kSlot = kRawBytes + kScaleBytes;
  static constexpr int kSplit = (kAParts + kBParts) * kTile;
  static constexpr int kFit =
      ((kSmemMax - 1024 - kPipes * kMeta) / kPipes - kSplit) / kSlot;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kPipe =
      (kSplit + kStages * kSlot + 1023) / 1024 * 1024;
  static constexpr int kSmem = 1024 + kPipes * kPipe + kPipes * kMeta;
  static_assert(kStages >= 3, "ring too shallow");
  static_assert(kSmem <= kSmemMax, "shared memory");
};

// the passes (part of A, part of B), smallest first: fp32 keeps i + j <=
// 2; rowwise multiplies A's one exact part by B's three; per block one
template <int PAY, int SCALE>
__host__ __device__ constexpr int pass_a(int ps) {
  if constexpr (PAY == kF32)
    return ps == 0 ? 2 : ps == 1 ? 1 : ps == 2 ? 0 : ps == 3 ? 1 : 0;
  return 0;
}
template <int PAY, int SCALE>
__host__ __device__ constexpr int pass_b(int ps) {
  if constexpr (PAY == kF32)
    return ps == 0 ? 0 : ps == 1 ? 1 : ps == 2 ? 2 : ps == 3 ? 0
                                                 : ps == 4 ? 1 : 0;
  if constexpr (SCALE == kRow) return 2 - ps;
  return 0;
}

// the 128 threads of pipeline `pipe`'s consumer warpgroup
__device__ __forceinline__ void pipe_sync(int pipe) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + pipe) : "memory");
}

// d (64 x 64 fp32, 32 registers a thread) = A @ B (+ d when accumulate):
// bf16 A K-major, B MN-major (transpose bit), both from shared memory.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                                uint64_t desc_a,
                                                uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// C is written once (a folded partial is read back once), so its stores
// stream past L2 (st.global.cs) and leave L2 to the tiles
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  __stcs(reinterpret_cast<float2*>(p), make_float2(v0, v1));
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
  __stcs(reinterpret_cast<unsigned*>(p), *reinterpret_cast<unsigned*>(&v));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// four payload bytes (element 0 in the low byte) to fp32, exactly
template <int PAY>
__device__ __forceinline__ void bytes4_to_f32(uint32_t w, float* v) {
  if constexpr (PAY == kI8) {
    // b + 128 in the low byte of 2^23's mantissa, then one subtraction
    const uint32_t u = w ^ 0x80808080u;
    v[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
    v[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
    v[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
    v[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
  } else {
    // e4m3 pairs to half2 (exact), then to fp32
    const __half2 lo(__nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(w & 0xFFFFu), __NV_E4M3));
    const __half2 hi(__nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(w >> 16), __NV_E4M3));
    const float2 a = __half22float2(lo), b = __half22float2(hi);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  }
}

// One stored 64 x 64 tile, raw as it came (fp32 or payload bytes,
// row-major; rowwise scales sc when ROWSCALE), to PARTS bf16 tiles at dst +
// p * kTile (0 = hi, 1 = mid, 2 = lo): 64 rows of 128 bytes, 16-byte chunk
// c of row r at chunk c ^ (r % 8), wgmma's 128-byte swizzle.  A tiles (M =
// row, K-major) and B tiles (K = row, MN-major) share it.  128 threads,
// four 8-value chunks each.
template <int PAY, bool ROWSCALE, int PARTS>
__device__ __forceinline__ void split_tile(const uint8_t* raw,
                                           const float* sc, uint8_t* dst,
                                           int t) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ci = t + 128 * i;
    const int row = ci >> 3;
    const int ch = ci & 7;
    float v[8];
    if constexpr (PAY == kF32) {
      const float4* p =
          reinterpret_cast<const float4*>(raw + (row * kT + 8 * ch) * 4);
      const float4 x0 = p[0], x1 = p[1];
      v[0] = x0.x; v[1] = x0.y; v[2] = x0.z; v[3] = x0.w;
      v[4] = x1.x; v[5] = x1.y; v[6] = x1.z; v[7] = x1.w;
    } else {
      const uint2 w = *reinterpret_cast<const uint2*>(raw + row * kT + 8 * ch);
      bytes4_to_f32<PAY>(w.x, v);
      bytes4_to_f32<PAY>(w.y, v + 4);
    }
    if constexpr (ROWSCALE) {
      const float s = sc[row];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __fmul_rn(v[j], s);
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
      if constexpr (PARTS == 3) {
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
    if constexpr (PARTS == 3) {
      *reinterpret_cast<uint4*>(dst + kTile + off) = m;
      *reinterpret_cast<uint4*>(dst + 2 * kTile + off) = l;
    }
  }
}

template <int PAY, int SCALE, typename TO>
__global__ void __launch_bounds__(Layout<PAY, SCALE>::kThreads, 1)
    segment_spgemm_tc_kernel(
    const uint8_t* __restrict__ a, const uint8_t* __restrict__ b, TO* c,
    const float* __restrict__ a_scales, const float* __restrict__ b_scales,
    const int* __restrict__ run_steps, const int* __restrict__ steps,
    int n_runs, int* __restrict__ next_run) {
  using Lay = Layout<PAY, SCALE>;
  constexpr int kPipes = Lay::kPipes;
  constexpr int kStages = Lay::kStages;
  constexpr bool kRowwise = SCALE == kRow;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_u32 = smem_u32(smem_raw);
  const uint32_t base = (raw_u32 + 1023) & ~1023u;   // 1 KiB for the swizzle
  uint8_t* const gbase = smem_raw + (base - raw_u32);

  const int pipe = threadIdx.x < 128 * kPipes
                       ? threadIdx.x / 128
                       : (threadIdx.x / 32) - 4 * kPipes;
  const uint32_t pbase = base + pipe * Lay::kPipe;
  uint8_t* const gpipe = gbase + pipe * Lay::kPipe;
  const uint32_t meta = base + kPipes * Lay::kPipe + pipe * kMeta;
  constexpr int kBarBytes = (2 * kMaxStages + 2 * kRows) * 8;
  int* const rows = reinterpret_cast<int*>(gbase + kPipes * Lay::kPipe +
                                           pipe * kMeta + kBarBytes);
  auto full = [&](int s) { return meta + 8 * s; };
  auto empty = [&](int s) { return meta + 8 * (kMaxStages + s); };
  auto row_full = [&](int q) { return meta + 8 * (2 * kMaxStages + q); };
  auto row_empty = [&](int q) {
    return meta + 8 * (2 * kMaxStages + kRows + q);
  };
  auto slot = [&](int s) { return Lay::kSplit + s * Lay::kSlot; };

  if (threadIdx.x == 0) {
    for (int p = 0; p < kPipes; ++p) {
      const uint32_t m = base + kPipes * Lay::kPipe + p * kMeta;
      for (int s = 0; s < kStages; ++s) {
        mbar_init(m + 8 * s, 1);
        mbar_init(m + 8 * (kMaxStages + s), 1);
      }
      for (int q = 0; q < kRows; ++q) {
        mbar_init(m + 8 * (2 * kMaxStages + q), 1);
        mbar_init(m + 8 * (2 * kMaxStages + kRows + q), 4);  // consumer warps
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  CK_BEGIN();
  CK(operand, kOpA, a, ck::kInput);
  CK(operand, kOpB, b, ck::kInput);
  CK(operand, kOpC, c, ck::kOutput);
  CK(operand, kOpAScales, a_scales, ck::kInput);
  CK(operand, kOpBScales, b_scales, ck::kInput);
  CK(operand, kOpRunSteps, run_steps, ck::kInput);
  CK(operand, kOpSteps, steps, ck::kInput);
  CK(operand, kOpNext, next_run, ck::kCounterOp);
  for (int p = 0; p < kPipes; ++p) {
    CK(ring, 2 * p, kStages, ck::kMbarrier);
    CK(ring, 2 * p + 1, kRows, ck::kMbarrier);
  }

  if (threadIdx.x >= 128 * kPipes) {
    // producer (lane 0 of warp 4 kPipes + pipe): takes the next run from
    // the launch's counter, so the runs in flight on the card are
    // neighbours in the table's Z-order; passes each of the run's rows to
    // the consumer through the row ring and loads the row's tiles into the
    // tile ring (tile n into slot n % kStages)
    if (threadIdx.x % 32) return;
    int n = 0, e = 0;
    auto load = [&](const uint8_t* src, const float* sc) {
      const int s = n % kStages;
      mbar_wait(empty(s), ((n / kStages) & 1) ^ 1);
      mbar_expect_tx(full(s), Lay::kRawBytes + (sc ? Lay::kScaleBytes : 0),
                     CK_TAG(true, 2 * pipe, s, 0));
      bulk_copy(pbase + slot(s), src, Lay::kRawBytes, full(s));
      if (sc) bulk_copy(pbase + slot(s) + Lay::kRawBytes, sc, Lay::kScaleBytes,
                        full(s));
      ++n;
    };
    auto push = [&](const int (&r)[kRow5]) {
      const int q = e % kRows;
      mbar_wait(row_empty(q), ((e / kRows) & 1) ^ 1);
#pragma unroll
      for (int i = 0; i < kRow5; ++i) rows[q * kRow5 + i] = r[i];
      CK(issue, 2 * pipe + 1, q, 0);
      mbar_arrive(row_full(q));   // releases the row to the consumer
      ++e;
    };
    int row[kRow5], nxt[kRow5];
    int st = 0, end = 0;
    // the next row of this pipeline, or -1 when the table is done
    auto next = [&]() {
      while (st >= end) {
        const int r = atomicAdd(next_run, 1);
        CK(counter, kOpNext, 0, r, 0);
        if (r >= n_runs) return -1;
        CK(gread, kOpRunSteps, run_steps, run_steps + r, 1, 2);
        st = run_steps[r];
        end = run_steps[r + 1];
      }
      return st++;
    };
    auto fetch = [&](int at) {
      const int* sp = steps + static_cast<long long>(at) * kRow5;
      CK(gread, kOpSteps, steps, sp, 1, kRow5);
#pragma unroll
      for (int i = 0; i < kRow5; ++i) nxt[i] = sp[i];
    };
    int cur = next();
    if (cur >= 0) fetch(cur);
    while (cur >= 0) {
#pragma unroll
      for (int i = 0; i < kRow5; ++i) row[i] = nxt[i];
      cur = next();
      if (cur >= 0) fetch(cur);   // a row ahead of its use
      push(row);
      if (row[0] < 0) continue;   // an item that is not valid loads nothing
      CK(gread, kOpA, a, a + static_cast<long long>(row[0]) * Lay::kRawBytes,
         1, Lay::kRawBytes);
      load(a + static_cast<long long>(row[0]) * Lay::kRawBytes, nullptr);
      const long long bi = row[2];
      CK(gread, kOpB, b, b + bi * Lay::kRawBytes, 1, Lay::kRawBytes);
      CK_IF(kRowwise, gread, kOpBScales, b_scales, b_scales + bi * kT, 1, kT);
      load(b + bi * Lay::kRawBytes, kRowwise ? b_scales + bi * kT : nullptr);
    }
#pragma unroll
    for (int i = 0; i < kRow5; ++i) row[i] = 0;
    row[0] = -2;                  // the end
    push(row);
    return;
  }

  // consumer warpgroup of this pipeline: the m64n64 fragment gives thread t
  // rows r0 and r0 + 8 and, in n8 block i, columns 8 i + c0 + {0, 1}
  // (register 4 i + 2 h + e: row h, column e)
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int r0 = 16 * warp + lane / 4;
  const int c0 = 2 * (lane % 4);
  const uint32_t abuf = pbase;
  const uint32_t bbuf = pbase + Lay::kAParts * kTile;
  float acc[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) acc[x] = 0.f;

  int n = 0;
  for (int e = 0;; ++e) {
    int row[kRow5];
    const int q = e % kRows;
    mbar_wait(row_full(q), (e / kRows) & 1,
              CK_TAG(t == 0, 2 * pipe + 1, q, 1));
    CK_IF(t == 0, read, 2 * pipe + 1, q, 1);
#pragma unroll
    for (int i = 0; i < kRow5; ++i) row[i] = rows[q * kRow5 + i];
    __syncwarp();
    if (lane == 0)
      mbar_arrive(row_empty(q), CK_TAG(t == 0, 2 * pipe + 1, q, 1));
    const int a_tile = row[0], fl = row[4];
    if (a_tile == -2) break;
    TO* ct = c + static_cast<long long>(row[3]) * (kT * kT);
    if (fl & kStart) {
      if (fl & kPrev) {
        CK_IF(t == 0, gread, kOpC, c, ct, 1, kT * kT);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 v = load2(ct + (r0 + 8 * h) * kT + 8 * i + c0);
            acc[4 * i + 2 * h] = v.x;
            acc[4 * i + 2 * h + 1] = v.y;
          }
      } else {
#pragma unroll
        for (int x = 0; x < 32; ++x) acc[x] = 0.f;
      }
    }
    if (a_tile >= 0) {   // a valid item: its A and B tiles are in the ring
      float sa[2] = {1.f, 1.f}, sb = 1.f;
      if constexpr (SCALE == kBlock) {
        CK_IF(t == 0, gread, kOpAScales, a_scales, a_scales + a_tile, 1, 1);
        CK_IF(t == 0, gread, kOpBScales, b_scales, b_scales + row[2], 1, 1);
        sa[0] = a_scales[a_tile];
        sb = b_scales[row[2]];
      } else if constexpr (kRowwise) {
        CK_IF(t == 0, gread, kOpAScales, a_scales,
              a_scales + static_cast<long long>(a_tile) * kT, 1, kT);
        sa[0] = a_scales[static_cast<long long>(a_tile) * kT + r0];
        sa[1] = a_scales[static_cast<long long>(a_tile) * kT + r0 + 8];
      }
      const int sa_slot = n % kStages;
      mbar_wait(full(sa_slot), (n / kStages) & 1,
                CK_TAG(t == 0, 2 * pipe, sa_slot, 1));
      ++n;
      const int sb_slot = n % kStages;
      mbar_wait(full(sb_slot), (n / kStages) & 1,
                CK_TAG(t == 0, 2 * pipe, sb_slot, 1));
      ++n;
      pipe_sync(pipe);   // every warp is past the last item's wgmma
      CK_IF(t == 0, read, 2 * pipe, sa_slot, 1);
      CK_IF(t == 0, read, 2 * pipe, sb_slot, 1);
      split_tile<PAY, false, Lay::kAParts>(gpipe + slot(sa_slot), nullptr,
                                           gpipe, t);
      split_tile<PAY, kRowwise, Lay::kBParts>(
          gpipe + slot(sb_slot),
          reinterpret_cast<const float*>(gpipe + slot(sb_slot) +
                                         Lay::kRawBytes),
          gpipe + Lay::kAParts * kTile, t);
      // the split tiles are read by wgmma, through the async proxy
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      pipe_sync(pipe);
      if (t == 0) {
        mbar_arrive(empty(sa_slot), CK_TAG(true, 2 * pipe, sa_slot, 1));
        mbar_arrive(empty(sb_slot), CK_TAG(true, 2 * pipe, sb_slot, 1));
      }
      float part[32];
      wgmma_fence();
#pragma unroll
      for (int ps = 0; ps < Lay::kPasses; ++ps) {
        const uint32_t at = abuf + pass_a<PAY, SCALE>(ps) * kTile;
        const uint32_t bt = bbuf + pass_b<PAY, SCALE>(ps) * kTile;
#pragma unroll
        for (int kk = 0; kk < kT / 16; ++kk) {
          // A K-major: a k16 slice is 32 bytes into each 128-byte row;
          // B MN-major: 16 rows (2 KiB) on
          wgmma_m64n64k16(part, smem_desc(at + kk * 32, 16, 1024),
                          smem_desc(bt + kk * 2048, kTile, 1024),
                          ps != 0 || kk != 0);
        }
      }
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        fence_operand(part[x]);
        if constexpr (SCALE == kBlock) {
          acc[x] = __fadd_rn(acc[x], __fmul_rn(__fmul_rn(part[x], sa[0]), sb));
        } else if constexpr (kRowwise) {
          acc[x] = __fadd_rn(acc[x], __fmul_rn(part[x], sa[(x >> 1) & 1]));
        } else {
          acc[x] = __fadd_rn(acc[x], part[x]);
        }
      }
    }
    CK_IF(t == 0 && (fl & kWrite), gwrite, kOpC, c, ct, 1, kT * kT);
    if (fl & kWrite) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          store2(ct + (r0 + 8 * h) * kT + 8 * i + c0, acc[4 * i + 2 * h],
                 acc[4 * i + 2 * h + 1]);
    }
  }
}

struct Args {
  const void* a;
  const void* b;
  void* c;
  const float* a_scales;
  const float* b_scales;
  const int* run_steps;
  const int* steps;
  int* next_run;
  int n_runs;
  cudaStream_t stream;
};

template <int PAY, int SCALE, typename TO>
int launch(const Args& x) {
  using Lay = Layout<PAY, SCALE>;
  auto kernel = segment_spgemm_tc_kernel<PAY, SCALE, TO>;
  // per device: the opt-in to > 48 KB of shared memory, and the SM count
  static bool attr_set[kMaxDevices] = {};
  static int sms[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return -1;
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set[dev] = true;
  }
  const int blocks = min(sms[dev], (x.n_runs + Lay::kPipes - 1) / Lay::kPipes);
  CK_LAUNCH("segment_spgemm_tc_kernel", x.stream);
  kernel<<<blocks, Lay::kThreads, Lay::kSmem, x.stream>>>(
      static_cast<const uint8_t*>(x.a), static_cast<const uint8_t*>(x.b),
      static_cast<TO*>(x.c), x.a_scales, x.b_scales, x.run_steps, x.steps,
      x.n_runs, x.next_run);
  return static_cast<int>(cudaGetLastError());
}

template <typename TO>
int by_mode(int payload, int scale_mode, const Args& x) {
  if (payload == kF32 && scale_mode == kNone)
    return launch<kF32, kNone, TO>(x);
  if (payload == kI8 && scale_mode == kBlock)
    return launch<kI8, kBlock, TO>(x);
  if (payload == kI8 && scale_mode == kRow) return launch<kI8, kRow, TO>(x);
  if (payload == kF8 && scale_mode == kBlock)
    return launch<kF8, kBlock, TO>(x);
  if (payload == kF8 && scale_mode == kRow) return launch<kF8, kRow, TO>(x);
  return -1;
}

}  // namespace

CK_NAMES("op:0:a op:1:b op:2:c op:3:a_scales op:4:b_scales op:5:run_steps "
         "op:6:steps op:7:next_run ring:0:tiles.0 ring:1:rows.0 "
         "ring:2:tiles.1 ring:3:rows.1 ring:4:tiles.2 ring:5:rows.2 "
         "ring:6:tiles.3 ring:7:rows.3")

extern "C" {

// C (n_c_blocks, 64, 64), row-major, fp32 or bf16 = the C blocks of
// BSR(A) @ BSR(B) under the plan's work table, on the tensor cores.  A and
// B: (n, 64, 64) contiguous, 16-byte aligned; payload 0 = fp32, 1 = int8,
// 2 = fp8-e4m3; scale_mode 0 = none (fp32 only), 1 = one fp32 scale per
// block, 2 = one per block row (a_scales (na, 64), b_scales (nb, 64),
// 16-byte aligned).  run_steps: n_runs + 1 offsets of the owner runs' rows
// in steps, in the order blocks take them; steps: (n_steps, 5) int32 rows
// (A tile or -1 for an item that is not valid, item, B tile, C block,
// flags: 1 valid, 2 seg_start, 4 accum_prev, 8 seg_write).  next_run: one
// int32, 0 at the launch (the blocks take runs from it).  Returns 0, a
// cudaError_t value, or -1 for a call out of range.
int segment_spgemm_tc(const void* a, const void* b, void* c,
                      const float* a_scales, const float* b_scales,
                      const int* run_steps, const int* steps, int* next_run,
                      int n_runs, int payload, int scale_mode, int c_bf16,
                      void* stream) {
  if (n_runs < 1 || reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16 ||
      reinterpret_cast<uintptr_t>(b_scales) % 16)
    return -1;
  const Args x{a, b, c, a_scales, b_scales, run_steps, steps, next_run,
               n_runs, static_cast<cudaStream_t>(stream)};
  return c_bf16 ? by_mode<__nv_bfloat16>(payload, scale_mode, x)
                : by_mode<float>(payload, scale_mode, x);
}

// Bytes of dynamic shared memory a segment_spgemm_tc launch asks for, by
// payload and scale mode; -1 for a call the launcher refuses.  No launch.
long long segment_spgemm_tc_smem_bytes(int payload, int scale_mode) {
  if (payload == kF32 && scale_mode == kNone) return Layout<kF32, kNone>::kSmem;
  if (payload == kI8 && scale_mode == kBlock) return Layout<kI8, kBlock>::kSmem;
  if (payload == kI8 && scale_mode == kRow) return Layout<kI8, kRow>::kSmem;
  if (payload == kF8 && scale_mode == kBlock) return Layout<kF8, kBlock>::kSmem;
  if (payload == kF8 && scale_mode == kRow) return Layout<kF8, kRow>::kSmem;
  return -1;
}

const char* segment_spgemm_tc_error_string(int code) {
  if (code == -1) return "call out of the tensor-core path's range";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
