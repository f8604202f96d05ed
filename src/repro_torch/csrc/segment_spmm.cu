// Segment-scheduled block-sparse x dense matmul: C = BSR(A) @ B (forward)
// or C = BSR(A)^T @ B (transpose_lhs, the backward pass's dx = W^T @ dy),
// on the CUDA cores.  Two kernels; the wrapper
// (src/repro_torch/kernels/segment_spmm.py, choose_path) picks one before
// the launch, and gives prefill and training widths to the tensor-core
// kernel of segment_spmm_tc.cu:
//
// - fold::segment_spmm_fold_kernel ("split"), 64 x 64 blocks and bf16 B at
//   the widths the tensor-core kernel does not take (decode widths), and
// - segment_spmm_kernel ("simt", one thread block per owner run), what
//   neither takes: fp32 B, 32 x 32 blocks.
//
// Replaces the TPU kernel src/repro/kernels/segment_spmm.py::segment_spmm
// (forward and transpose_lhs modes; fp32 blocks, and int8 / fp8-e4m3
// payloads with per-block or rowwise fp32 scales) for those calls.  Built
// with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a library with the plain C interface at the bottom of this file,
// loaded from Python with ctypes (src/repro_torch/kernels/build.py).
//
// Owner runs.  The TPU grid walks one lane per core and keeps a C tile in
// VMEM across consecutive items of the same output block row.  On the GPU
// a lane is far too little parallelism (the sparse FFN plans one lane),
// but the planner keeps every output block row (its "owner run": all of
// its items, folded continuations included) contiguous inside one lane,
// and the wrapper derives the run offsets once per plan.
//
// The one-block-per-run kernel gives each (N tile, owner run) a thread
// block that walks the run's items in schedule order, which is exact and
// needs no atomics.  N tiles are the fast grid axis, so the tiles of one
// run run back to back and share its A tiles in L2.  Per item the block
// follows the plan's flags as the TPU kernel does: zero the fp32
// accumulator at seg_start, reload it from C at accum_prev (folded
// continuation: the same thread wrote that element at the segment's
// earlier seg_write), add A_tile @ B_slice when valid, store at seg_write.
// Pad items (valid == 0) carry no flags and move no data.
//
// The folded kernel is the paper's spatial fold: partial work moves to
// idle processing elements and is merged after.  Granite-3-8b's FFN has
// 64 runs of 50 items (down, up's dx) or 200 of 16 (up, gate, down's dx);
// one block a run leaves SMs idle and walks 50 tiles in series.  So each
// run is cut into chunks of at most c items (the plan's chunk table,
// derived once per plan on the host: 400-448 chunks at c = 8, 3-3.4
// blocks an SM), one block takes one (N tile, chunk), sums its valid items
// into fp32 registers and, where the run has more than one chunk, stores
// its partial tile in a workspace; an integer arrival counter per (run, N
// tile) finds the last block of the run to finish, which adds the run's
// partials in chunk order and writes C (no float atomics: the result
// depends on the schedule only, so a cross_pass plan equals its drained
// plan bit for bit).  The flags are not read: an owner's items all lie in
// its run, and the planner's flags (a segment head zeroes the tile, a
// continuation reloads what the owner's previous segment stored, the last
// segment stores) leave in C exactly the sum of the run's valid items, on
// folded (fold_len), multi-lane, unrolled, static-order and holed plans
// alike; in bf16 C that sum is rounded once, where the flags round it at
// every stored segment.  Each item's contraction is cut among the block's
// threads so that every thread runs several independent FMA chains (the
// one-block-per-run kernel's transposed loop at N tile 4 is one dependent
// chain of 64), and summed across the threads once per chunk by a
// shuffle reduce-scatter.  int8/e4m3 payloads stay 1 byte an element in
// the ring and each thread converts the bytes it multiplies in its
// registers, so no second barrier per item is needed.
//
// Transposed mode.  The backward plan (the planner's grad_plan) schedules
// W^T's block rows, but its slot_idx addresses the forward weight storage,
// so each item contracts the stored tile along its row axis: C rows are the
// stored tile's columns.  Nothing is transposed in memory.  The A tile lands
// in shared memory as in the forward mode; what changes is which C rows a
// thread owns.  In the one-block-per-run kernel, forward, a thread owns
// rows interleaved across the tile and reads float4s along k of each A
// row.  Transposed, it owns P contiguous rows, which are P contiguous words
// of one stored A row, so it reads them with vector loads; the threads of a
// warp that share a row group read the same words (a broadcast) and
// different groups read neighbouring words, so the reads are free of bank
// conflicts and no shared-memory transpose (and no extra barrier) is
// needed.
//
// Data movement.  A tiles (bm x bk, addressed through slot_idx in BSR
// storage order) stream through a 3-stage shared-memory ring filled with
// cp.async, so the next two tiles are in flight while one is multiplied.
// fp32 tiles land in the ring as the fp32 tiles the inner loop reads.
// Quantized payloads move as they are, 1 byte an element (a quarter of the
// fp32 bytes: what the quantized modes buy at decode widths).  In the
// one-block-per-run kernel the threads that copied them convert them after
// the item's barrier, 16 bytes (one uint4 read) each, into one fp32 tile in
// shared memory, which a second barrier publishes; its inner loop is then
// the fp32 one in every mode.  int8 converts by sign extension; e4m3
// converts in pairs through the fp8x2 -> f16x2 conversion (exact: every
// e4m3 value is a half), then to fp32.  The B slice (contraction x tile_n)
// of the next item is loaded into registers during the current item's
// arithmetic and stored to a second shared buffer after it.  N tiles are
// 4..32 wide (4..16 folded): a 64-wide tile needs 16 accumulators and 16
// staged B values a thread and spills at 255 registers.  B is read by
// stride, so the sparse FFN's B = x.T (a transposed view, k-contiguous)
// and the backward pass's dy (also a transposed view) need no copy; the
// loader lets neighbouring threads walk whichever axis has unit stride.
// The ragged N edge is masked here, so B is never padded.
//
// Numerics.  Accumulation is fp32 on the CUDA cores (fmaf), never TF32 mma,
// to keep fp32 parity with the reference.  B may be fp32 or bf16 (converted
// to fp32 on load); C is written as fp32 or bf16.  Quantized payloads keep
// the TPU kernel's order.  Rowwise scales index the stored tile's rows,
// which are the contraction axis under transpose_lhs, so they do not factor
// out of the product: each element is multiplied by its row's scale when
// it is converted, before the product, in both modes.  A per-block scale
// is a scalar of the tile: the item's product is summed into its own
// registers, multiplied by the scale and then added to the accumulator
// (both roundings kept, no fused multiply-add), as contrib * scale is added
// in the TPU kernel.
//
// Bound.  At decode widths (N = 4) the kernel must read every stored A
// tile once: 3200 tiles of 64x64 fp32 = 52.4 MB per FFN projection, which is
// 15.7 us at 3.35 TB/s, so bytes bind; an int8/fp8 payload is 13.1 MB plus
// 12.8 KB of per-block scales (819 KB rowwise), 4.0-4.2 us.  At N = 64 the
// 1.68 GFLOP against the 67 TFLOP/s fp32 CUDA-core peak (25 us) binds.  The
// folded kernel keeps 3-4 blocks of each SM with two A tiles in flight
// each (~100 KB an SM) for the first.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kStages = 3;       // depth of the A-tile ring
constexpr int kMaxDevices = 64;
// the checked build's operands and ring (check.cuh); the schedule arrays
// are numbered in their argument order from kOpSlot on
enum CkOp {
  kOpA = 0, kOpScales, kOpB, kOpC, kOpSlot, kOpM, kOpK, kOpStart, kOpWrite,
  kOpPrev, kOpValid, kOpRuns, kOpWork, kOpCounters
};
constexpr int kRingA = 0;

enum Payload { kF32 = 0, kI8 = 1, kF8 = 2 };
enum ScaleMode { kNone = 0, kBlock = 1, kRow = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Four payload elements (one 32-bit word, the first in the low byte) to
// fp32; exact for both payload types.
template <int PAY>
__device__ __forceinline__ void word_to_f32x4(unsigned w, float* v) {
  if constexpr (PAY == kI8) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = static_cast<float>(
          static_cast<signed char>(static_cast<unsigned char>(w >> (8 * j))));
  } else {
    const float2 lo = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(w & 0xffffu), __NV_E4M3)));
    const float2 hi = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(w >> 16), __NV_E4M3)));
    v[0] = lo.x;
    v[1] = lo.y;
    v[2] = hi.x;
    v[3] = hi.y;
  }
}

// P consecutive floats from shared memory, in the widest aligned vectors
// (the caller keeps p aligned to min(P, 4) floats).
template <int P>
__device__ __forceinline__ void load_run(const float* p, float (&v)[P]) {
  if constexpr (P % 4 == 0) {
#pragma unroll
    for (int j = 0; j < P; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + j);
      v[j] = q.x;
      v[j + 1] = q.y;
      v[j + 2] = q.z;
      v[j + 3] = q.w;
    }
  } else if constexpr (P == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
#pragma unroll
    for (int j = 0; j < P; ++j) v[j] = p[j];
  }
}

// Bytes of one ring stage: an fp32 A tile with padded rows, or the raw
// bm x bk payload bytes.
template <int BM, int BK, int PAY>
__host__ __device__ constexpr int ring_stage_bytes() {
  return PAY == kF32 ? int(sizeof(float)) * BM * (BK + 4) : BM * BK;
}

// Shared memory: the ring, then (1-byte payloads) one fp32 A tile, then
// the two B buffers.
template <int BM, int BK, int TN, bool TRANS, int PAY>
constexpr size_t smem_bytes() {
  constexpr int KC = TRANS ? BM : BK;  // contraction length
  constexpr size_t a32 = PAY == kF32 ? 0 : sizeof(float) * BM * (BK + 4);
  return size_t(kStages) * ring_stage_bytes<BM, BK, PAY>() + a32 +
         sizeof(float) * size_t(2) * KC * (TN + 1);
}

// One thread block per (N tile, owner run); 4*BM threads.  Thread t owns
// column t % TN of the tile and TN / 4 of its rows: rows t / TN + i * NG
// in the forward mode, rows (t / TN) * P + i in the transposed mode.
template <int BM, int BK, int TN, bool TRANS, int PAY, int SCALE, typename TB,
          typename TO>
__global__ void __launch_bounds__(4 * BM) segment_spmm_kernel(
    const void* __restrict__ a, const float* __restrict__ a_scales,
    const TB* __restrict__ b, TO* c, const int* __restrict__ slot_idx,
    const int* __restrict__ m_idx, const int* __restrict__ k_idx,
    const int* __restrict__ seg_start, const int* __restrict__ seg_write,
    const int* __restrict__ accum_prev, const int* __restrict__ valid,
    const int* __restrict__ run_off, int n, long long sbk, long long sbn) {
  constexpr int THREADS = 4 * BM;
  constexpr int OM = TRANS ? BK : BM;      // rows of a C tile
  constexpr int KC = TRANS ? BM : BK;      // contraction length of an item
  constexpr int AP = BK + 4;               // padded A row, 16-byte aligned
  constexpr int BP = TN + 1;               // padded B row, conflict-free
  constexpr int NG = THREADS / TN;         // row groups
  constexpr int P = OM / NG;               // outputs per thread
  constexpr int BEL = KC * TN / THREADS;   // B elements per thread per item
  constexpr int ACH = BM * BK / 4 / THREADS;  // 16-byte fp32 A chunks each
  constexpr int QTOT = BM * BK / 16;       // 16-byte chunks of a payload tile
  constexpr int QCH = (QTOT + THREADS - 1) / THREADS;
  constexpr int RING = ring_stage_bytes<BM, BK, PAY>();
  static_assert(THREADS % TN == 0 && OM % NG == 0, "bad N tile");
  static_assert((KC * TN) % THREADS == 0, "bad B split");
  static_assert((BM * BK / 4) % THREADS == 0 && BK % 16 == 0, "bad A split");
  static_assert((PAY == kF32) == (SCALE == kNone),
                "scales go with 1-byte payloads and only with them");

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* const ring = smem;        // [kStages][RING bytes]
  // the converted fp32 tile of a quantized item, [BM][AP]
  float* const a32 = reinterpret_cast<float*>(smem + kStages * RING);
  float* const bs = a32 + (PAY == kF32 ? 0 : BM * AP);  // [2][KC][BP]

  const int t = threadIdx.x;
  const int lo = run_off[blockIdx.y];
  const int hi = run_off[blockIdx.y + 1];
  const int n0 = blockIdx.x * TN;
  const int col = t % TN;
  const int grp = t / TN;
  const bool col_ok = n0 + col < n;
  const long long row0 = static_cast<long long>(m_idx[lo]) * OM;
  const bool k_fast = sbk == 1;  // B is k-contiguous (x.T or dy views)
  auto out_row = [&](int i) { return TRANS ? grp * P + i : grp + i * NG; };
  CK_BEGIN();
  CK(operand, kOpA, static_cast<const unsigned char*>(a), ck::kInput);
  CK(operand, kOpScales, a_scales, ck::kInput);
  CK(operand, kOpB, b, ck::kInput);
  CK(operand, kOpC, c, ck::kOutput);
  CK(operand_each, kOpSlot, ck::kInput, slot_idx, m_idx, k_idx, seg_start,
     seg_write, accum_prev, valid);
  CK(operand, kOpRuns, run_off, ck::kInput);
  CK(ring, kRingA, kStages, ck::kGroups);
  CK_IF(t == 0, gread, kOpRuns, run_off, run_off + blockIdx.y, 1, 2);
  CK_IF(t == 0, gread, kOpM, m_idx, m_idx + lo, 1, 1);
  CK_IF(t == 0, gread_each, kOpSlot, lo, hi - lo, slot_idx, m_idx, k_idx,
        seg_start, seg_write, accum_prev, valid);

  auto issue_a = [&](int it) {
    if (it < hi && valid[it]) {
      unsigned char* dst = ring + ((it - lo) % kStages) * RING;
      const long long slot = slot_idx[it];
      CK_IF(t == 0, issue, kRingA, (it - lo) % kStages);
      CK_IF(t == 0, gread, kOpA, static_cast<const unsigned char*>(a),
            static_cast<const unsigned char*>(a) +
                slot * (BM * BK * (PAY == kF32 ? 4 : 1)),
            1, BM * BK * (PAY == kF32 ? 4 : 1));
      if constexpr (PAY == kF32) {
        const float* src = static_cast<const float*>(a) + slot * (BM * BK);
        float* d = reinterpret_cast<float*>(dst);
#pragma unroll
        for (int q = 0; q < ACH; ++q) {
          const int idx = t + q * THREADS;
          const int r = idx / (BK / 4);
          const int c4 = (idx % (BK / 4)) * 4;
          cp_async16(d + r * AP + c4, src + r * BK + c4);
        }
      } else {
        const unsigned char* src =
            static_cast<const unsigned char*>(a) + slot * (BM * BK);
#pragma unroll
        for (int q = 0; q < QCH; ++q) {
          const int idx = t + q * THREADS;
          if (idx < QTOT) cp_async16(dst + idx * 16, src + idx * 16);
        }
      }
    }
    // empty groups keep the wait count uniform
    cp_async_commit(CK_TAG(t == 0, kRingA, 0, 0));
  };

  // 1-byte payloads: the 16-byte chunks this thread copied for item `it`,
  // to fp32 (times their row's scale in the rowwise mode)
  auto convert_a = [&](int it) {
    const unsigned char* src = ring + ((it - lo) % kStages) * RING;
#pragma unroll
    for (int q = 0; q < QCH; ++q) {
      const int idx = t + q * THREADS;
      if (idx < QTOT) {
        const int r = idx * 16 / BK;
        const int c0 = idx * 16 % BK;
        const uint4 w = *reinterpret_cast<const uint4*>(src + idx * 16);
        float v[16];
        word_to_f32x4<PAY>(w.x, v);
        word_to_f32x4<PAY>(w.y, v + 4);
        word_to_f32x4<PAY>(w.z, v + 8);
        word_to_f32x4<PAY>(w.w, v + 12);
        if constexpr (SCALE == kRow) {
          CK_IF(t == 0 && q == 0, gread, kOpScales, a_scales,
                a_scales + static_cast<long long>(slot_idx[it]) * BM, 1, BM);
          const float s =
              a_scales[static_cast<long long>(slot_idx[it]) * BM + r];
#pragma unroll
          for (int j = 0; j < 16; ++j) v[j] *= s;
        }
#pragma unroll
        for (int j = 0; j < 16; j += 4)
          *reinterpret_cast<float4*>(a32 + r * AP + c0 + j) =
              make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
      }
    }
  };

  float breg[BEL];
  auto b_coord = [&](int e, int& kk, int& nn) {
    const int idx = t + e * THREADS;
    if (k_fast) {
      kk = idx % KC;
      nn = idx / KC;
    } else {
      nn = idx % TN;
      kk = idx / TN;
    }
  };
  auto load_b = [&](int it) {
    if (it < hi && valid[it]) {
      const TB* src = b + static_cast<long long>(k_idx[it]) * KC * sbk;
      CK_IF(t == 0, gread, kOpB, b, src + n0 * sbn, KC, min(TN, n - n0), sbk,
            static_cast<int>(sbn));
#pragma unroll
      for (int e = 0; e < BEL; ++e) {
        int kk, nn;
        b_coord(e, kk, nn);
        breg[e] = n0 + nn < n ? to_f32(src[kk * sbk + (n0 + nn) * sbn]) : 0.f;
      }
    }
  };
  auto store_b = [&](int it) {
    if (it < hi && valid[it]) {
      float* dst = bs + ((it - lo) & 1) * (KC * BP);
#pragma unroll
      for (int e = 0; e < BEL; ++e) {
        int kk, nn;
        b_coord(e, kk, nn);
        dst[kk * BP + nn] = breg[e];
      }
    }
  };

  // d[i] += this thread's outputs of A_tile @ B_slice (fp32 tiles)
  auto mac = [&](const float* at, const float* bt, float(&d)[P]) {
    if constexpr (TRANS) {
      // C[j] += sum_r A[r][j] * B[r]: stored row r holds this thread's
      // P outputs side by side
#pragma unroll 4
      for (int r = 0; r < KC; ++r) {
        const float bv = bt[r * BP];
        float av[P];
        load_run<P>(at + r * AP + grp * P, av);
#pragma unroll
        for (int i = 0; i < P; ++i) d[i] = fmaf(av[i], bv, d[i]);
      }
    } else {
#pragma unroll 4
      for (int k = 0; k < KC; k += 4) {
        const float b0 = bt[k * BP];
        const float b1 = bt[(k + 1) * BP];
        const float b2 = bt[(k + 2) * BP];
        const float b3 = bt[(k + 3) * BP];
#pragma unroll
        for (int i = 0; i < P; ++i) {
          const float4 av =
              *reinterpret_cast<const float4*>(at + out_row(i) * AP + k);
          d[i] = fmaf(av.x, b0, d[i]);
          d[i] = fmaf(av.y, b1, d[i]);
          d[i] = fmaf(av.z, b2, d[i]);
          d[i] = fmaf(av.w, b3, d[i]);
        }
      }
    }
  };

  float acc[P];
#pragma unroll
  for (int i = 0; i < P; ++i) acc[i] = 0.f;

  for (int s = 0; s < kStages - 1; ++s) issue_a(lo + s);
  load_b(lo);
  store_b(lo);

  for (int it = lo; it < hi; ++it) {
    cp_async_wait<kStages - 2>();  // this thread's copies of item `it` landed
    __syncthreads();               // everyone's copies and B stores visible;
                                   // item it-1's buffers are free again
    CK_IF(t == 0, groups, kRingA, kStages - 2);
    CK_IF(t == 0 && it > lo && valid[it - 1], release, kRingA,
          (it - 1 - lo) % kStages);
    issue_a(it + kStages - 1);
    load_b(it + 1);
    CK_IF(t == 0 && valid[it], read, kRingA, (it - lo) % kStages);
    const float* at;
    if constexpr (PAY == kF32) {
      at = reinterpret_cast<const float*>(ring + ((it - lo) % kStages) * RING);
    } else {
      if (valid[it]) convert_a(it);
      __syncthreads();             // the fp32 tile is complete
      at = a32;
    }

    if (seg_start[it]) {
      if (accum_prev[it]) {
        CK_IF(t == 0, gread, kOpC, c, c + row0 * n + n0, OM, min(TN, n - n0),
              n);
#pragma unroll
        for (int i = 0; i < P; ++i)
          acc[i] = col_ok ? to_f32(c[(row0 + out_row(i)) * n + n0 + col])
                          : 0.f;
      } else {
#pragma unroll
        for (int i = 0; i < P; ++i) acc[i] = 0.f;
      }
    }
    if (valid[it]) {
      const float* bt = bs + ((it - lo) & 1) * (KC * BP) + col;
      if constexpr (SCALE == kBlock) {
        float part[P];
#pragma unroll
        for (int i = 0; i < P; ++i) part[i] = 0.f;
        mac(at, bt, part);
        CK_IF(t == 0, gread, kOpScales, a_scales, a_scales + slot_idx[it], 1,
              1);
        const float s = a_scales[slot_idx[it]];
#pragma unroll
        for (int i = 0; i < P; ++i)
          acc[i] = __fadd_rn(acc[i], __fmul_rn(part[i], s));
      } else {
        mac(at, bt, acc);
      }
    }
    CK_IF(t == 0 && seg_write[it], gwrite, kOpC, c, c + row0 * n + n0, OM,
          min(TN, n - n0), n);
    if (seg_write[it] && col_ok) {
#pragma unroll
      for (int i = 0; i < P; ++i)
        store_as(&c[(row0 + out_row(i)) * n + n0 + col], acc[i]);
    }
    store_b(it + 1);
  }
  cp_async_wait<0>();
  CK_IF(t == 0, groups, kRingA, 0);
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
  int n;
  long long sbk;
  long long sbn;
  cudaStream_t stream;
};

template <int BM, int TN, bool TRANS, int PAY, int SCALE, typename TB,
          typename TO>
int launch(const Args& x) {
  constexpr size_t smem = smem_bytes<BM, BM, TN, TRANS, PAY>();
  auto kernel = segment_spmm_kernel<BM, BM, TN, TRANS, PAY, SCALE, TB, TO>;
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
  const dim3 grid((x.n + TN - 1) / TN, x.n_runs);
  CK_LAUNCH("segment_spmm_kernel", x.stream);
  kernel<<<grid, 4 * BM, smem, x.stream>>>(
      x.a, x.a_scales, static_cast<const TB*>(x.b), static_cast<TO*>(x.c),
      x.slot_idx, x.m_idx, x.k_idx, x.seg_start, x.seg_write, x.accum_prev,
      x.valid, x.run_off, x.n, x.sbk, x.sbn);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, bool TRANS, int PAY, int SCALE, typename TB, typename TO>
int by_tile(int tile_n, const Args& x) {
  switch (tile_n) {
    case 4: return launch<BM, 4, TRANS, PAY, SCALE, TB, TO>(x);
    case 8: return launch<BM, 8, TRANS, PAY, SCALE, TB, TO>(x);
    case 16: return launch<BM, 16, TRANS, PAY, SCALE, TB, TO>(x);
    case 32: return launch<BM, 32, TRANS, PAY, SCALE, TB, TO>(x);
  }
  return -1;
}

template <int BM, bool TRANS, int PAY, int SCALE>
int by_dtype(int b_bf16, int c_bf16, int tile_n, const Args& x) {
  using bf16 = __nv_bfloat16;
  if (!b_bf16 && !c_bf16)
    return by_tile<BM, TRANS, PAY, SCALE, float, float>(tile_n, x);
  if (!b_bf16 && c_bf16)
    return by_tile<BM, TRANS, PAY, SCALE, float, bf16>(tile_n, x);
  // 64 x 64 blocks with bf16 B run on the folded or tensor-core kernels
  if constexpr (BM == 64) {
    return -1;
  } else {
    if (!c_bf16) return by_tile<BM, TRANS, PAY, SCALE, bf16, float>(tile_n, x);
    return by_tile<BM, TRANS, PAY, SCALE, bf16, bf16>(tile_n, x);
  }
}

template <int BM, bool TRANS>
int by_payload(int payload, int scale_mode, int b_bf16, int c_bf16,
               int tile_n, const Args& x) {
  if (payload == kF32 && scale_mode == kNone)
    return by_dtype<BM, TRANS, kF32, kNone>(b_bf16, c_bf16, tile_n, x);
  if (payload == kI8 && scale_mode == kBlock)
    return by_dtype<BM, TRANS, kI8, kBlock>(b_bf16, c_bf16, tile_n, x);
  if (payload == kI8 && scale_mode == kRow)
    return by_dtype<BM, TRANS, kI8, kRow>(b_bf16, c_bf16, tile_n, x);
  if (payload == kF8 && scale_mode == kBlock)
    return by_dtype<BM, TRANS, kF8, kBlock>(b_bf16, c_bf16, tile_n, x);
  if (payload == kF8 && scale_mode == kRow)
    return by_dtype<BM, TRANS, kF8, kRow>(b_bf16, c_bf16, tile_n, x);
  return -1;
}

template <int BM>
int by_mode(int trans, int payload, int scale_mode, int b_bf16, int c_bf16,
            int tile_n, const Args& x) {
  return trans ? by_payload<BM, true>(payload, scale_mode, b_bf16, c_bf16,
                                      tile_n, x)
               : by_payload<BM, false>(payload, scale_mode, b_bf16, c_bf16,
                                       tile_n, x);
}


// ---------------------------------------------------------------------------
// The folded kernel: one thread block per (N tile, chunk of an owner run)
// ---------------------------------------------------------------------------
namespace fold {

constexpr int kBM = 64;          // 64 x 64 blocks only
constexpr int kThreads = 256;
constexpr int kStages = 3;       // depth of the A-tile ring

// A row in the ring: fp32 rows padded to 68 floats, payload rows to 80
// bytes (16-byte aligned; the reads below are then free of bank conflicts)
template <int PAY>
__host__ __device__ constexpr int row_bytes() {
  return PAY == kF32 ? 4 * (kBM + 4) : kBM + 16;
}
// a stage: the tile, then its rowwise scales or its per-block scale
template <int PAY, int SCALE>
__host__ __device__ constexpr int stage_bytes() {
  return kBM * row_bytes<PAY>() +
         (SCALE == kRow ? 4 * kBM : (SCALE == kBlock ? 16 : 0));
}
template <int TN>
__host__ __device__ constexpr int b_pitch() {
  return TN == 4 ? 4 : TN + 4;   // conflict-free float4 reads of B rows
}
template <int TN, int PAY, int SCALE>
constexpr size_t smem_bytes() {
  return size_t(kStages) * stage_bytes<PAY, SCALE>() +
         sizeof(float) * 2 * kBM * b_pitch<TN>();
}
// resident blocks an SM the register budget is set for: by the partial
// sums a thread keeps (doubled by a per-block scale's per-item sums; 4 x
// 256 threads leave 64 registers a thread) and by the shared memory
template <int TN, int PAY, int SCALE>
constexpr int min_blocks() {
  constexpr int acc = 4 * TN * (SCALE == kBlock ? 2 : 1);
  constexpr int by_regs =
      acc <= 16 ? 4 : (acc <= 32 ? 3 : (acc <= 64 ? 2 : 1));
  constexpr int by_smem =
      int(232448 / (smem_bytes<TN, PAY, SCALE>() + 1024));
  return by_regs < by_smem ? by_regs : by_smem;
}

// Sums v over the L lanes that differ in lane bits 0 .. log2(L) - 1, as a
// reduce-scatter: each round a lane keeps one half of its values (the
// upper half where the round's lane bit is set), adds its partner's copy
// of that half and passes the other.  Afterwards v[0 .. V/L) of a lane are
// the sums of values base .. base + V/L - 1; returns base.  Deterministic:
// the same lanes add the same values in the same order on every call.
template <int CNT, int H, int L>
__device__ __forceinline__ void rs_round(float* v, int lane, int& base) {
  if constexpr (H < L) {
    const bool up = lane & H;
#pragma unroll
    for (int i = 0; i < CNT / 2; ++i) {
      const float lo = v[i], hi = v[i + CNT / 2];
      const float keep = up ? hi : lo;
      const float send = up ? lo : hi;
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
    }
    if (up) base += CNT / 2;
    rs_round<CNT / 2, 2 * H, L>(v, lane, base);
  }
}

// One thread block per (N tile, chunk).  A chunk is at most c consecutive
// items of one owner run (the plan's chunk table: first item, end, the
// run's first chunk, the run's chunk count).  256 threads; each item's
// contraction is cut among 16 threads, so that every thread runs 4 TN
// independent FMA chains of 4, and summed across them once per chunk.
// Thread t owns four outputs, 4 (t / 16) .. + 3, for all TN columns:
// forward they are stored rows, and the thread multiplies their stored
// columns 4 (t % 16) .. + 3 (one float4 of each row); transposed they are
// stored columns, and it multiplies stored rows 16 i + t % 16 (i < 4; one
// float4 of each row).  The forward mode stores the B slice's row k at
// row (k % 4) 16 + k / 4, so the 16 threads of a group read 16
// consecutive B rows, as in the transposed mode: no bank conflicts.
template <int TN, bool TRANS, int PAY, int SCALE, typename TO>
__global__ void __launch_bounds__(kThreads, min_blocks<TN, PAY, SCALE>())
    segment_spmm_fold_kernel(
        const void* __restrict__ a, const float* __restrict__ a_scales,
        const __nv_bfloat16* __restrict__ b, TO* c,
        const int* __restrict__ slot_idx, const int* __restrict__ m_idx,
        const int* __restrict__ k_idx, const int* __restrict__ valid,
        const int4* __restrict__ chunks, float* work, int* counters, int n,
        long long sbk, long long sbn) {
  constexpr int RB = row_bytes<PAY>();
  constexpr int STAGE = stage_bytes<PAY, SCALE>();
  constexpr int BP = b_pitch<TN>();
  constexpr int BEL = kBM * TN / kThreads;   // B elements a thread stages
  constexpr int V = 4 * TN;                  // a thread's partial sums
  constexpr int L = 16;                      // threads sharing an output
  constexpr int NV = V / L;                  // outputs a thread owns after
  static_assert(BEL >= 1 && NV >= 1 && TN % 4 == 0, "bad N tile");
  static_assert((PAY == kF32) == (SCALE == kNone),
                "scales go with 1-byte payloads and only with them");

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* const ring = smem;                      // [kStages][STAGE]
  float* const bs = reinterpret_cast<float*>(smem + kStages * STAGE);
  __shared__ int last;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int4 ch = chunks[blockIdx.y];
  const int lo = ch.x, hi = ch.y;
  const int tile = blockIdx.x;
  const int n0 = tile * TN;
  const long long row0 = static_cast<long long>(m_idx[lo]) * kBM;
  const bool k_fast = sbk == 1;   // B is k-contiguous (x.T or dy views)
  // outputs 4 og .. 4 og + 3; contraction share rs
  const int rs = t & 15, og = t >> 4;
  CK_BEGIN();
  CK(operand, kOpA, static_cast<const unsigned char*>(a), ck::kInput);
  CK(operand, kOpScales, a_scales, ck::kInput);
  CK(operand, kOpB, b, ck::kInput);
  CK(operand, kOpC, c, ck::kOutput);
  CK(operand_each, kOpSlot, ck::kInput, slot_idx, m_idx, k_idx);
  CK(operand, kOpValid, valid, ck::kInput);
  CK(operand, kOpRuns, reinterpret_cast<const int*>(chunks), ck::kInput);
  CK(operand, kOpWork, work, ck::kWorkspace);
  CK(operand, kOpCounters, counters, ck::kCounterOp);
  CK(ring, kRingA, kStages, ck::kGroups);
  CK_IF(t == 0, gread, kOpRuns, reinterpret_cast<const int*>(chunks),
        reinterpret_cast<const int*>(chunks) + 4 * blockIdx.y, 1, 4);
  CK_IF(t == 0, gread, kOpM, m_idx, m_idx + lo, 1, 1);
  CK_IF(t == 0, gread_each, kOpSlot, lo, hi - lo, slot_idx);
  CK_IF(t == 0, gread, kOpK, k_idx, k_idx + lo, 1, hi - lo);
  CK_IF(t == 0, gread, kOpValid, valid, valid + lo, 1, hi - lo);

  auto issue_a = [&](int it) {
    if (it < hi && valid[it]) {
      unsigned char* dst = ring + ((it - lo) % kStages) * STAGE;
      const long long slot = slot_idx[it];
      CK_IF(t == 0, issue, kRingA, (it - lo) % kStages);
      CK_IF(t == 0, gread, kOpA, static_cast<const unsigned char*>(a),
            static_cast<const unsigned char*>(a) +
                slot * (kBM * kBM * (PAY == kF32 ? 4 : 1)),
            1, kBM * kBM * (PAY == kF32 ? 4 : 1));
      CK_IF(t == 0 && SCALE != kNone, gread, kOpScales, a_scales,
            a_scales + slot * (SCALE == kRow ? kBM : 1), 1,
            SCALE == kRow ? kBM : 1);
      if constexpr (PAY == kF32) {
        const float* src = static_cast<const float*>(a) + slot * (kBM * kBM);
#pragma unroll
        for (int q = 0; q < kBM * kBM / 4 / kThreads; ++q) {
          const int idx = t + q * kThreads;
          const int r = idx / (kBM / 4);
          const int c4 = (idx % (kBM / 4)) * 4;
          cp_async16(dst + r * RB + 4 * c4, src + r * kBM + c4);
        }
      } else {
        const unsigned char* src =
            static_cast<const unsigned char*>(a) + slot * (kBM * kBM);
        const int r = t / 4, c16 = (t % 4) * 16;   // one 16-byte chunk each
        cp_async16(dst + r * RB + c16, src + r * kBM + c16);
        if constexpr (SCALE == kRow) {
          if (t < kBM / 4)
            cp_async16(dst + kBM * RB + 16 * t, a_scales + slot * kBM + 4 * t);
        } else {
          if (t == 0) cp_async4(dst + kBM * RB, a_scales + slot);
        }
      }
    }
    // empty groups keep the wait count uniform
    cp_async_commit(CK_TAG(t == 0, kRingA, 0, 0));
  };

  float breg[BEL];
  auto b_coord = [&](int e, int& kk, int& nn) {
    const int idx = t + e * kThreads;
    if (k_fast) {
      kk = idx % kBM;
      nn = idx / kBM;
    } else {
      nn = idx % TN;
      kk = idx / TN;
    }
  };
  auto load_b = [&](int it) {
    if (it < hi && valid[it]) {
      const __nv_bfloat16* src =
          b + static_cast<long long>(k_idx[it]) * kBM * sbk;
      CK_IF(t == 0, gread, kOpB, b, src + n0 * sbn, kBM, min(TN, n - n0), sbk,
            static_cast<int>(sbn));
#pragma unroll
      for (int e = 0; e < BEL; ++e) {
        int kk, nn;
        b_coord(e, kk, nn);
        breg[e] = n0 + nn < n ? to_f32(src[kk * sbk + (n0 + nn) * sbn]) : 0.f;
      }
    }
  };
  auto store_b = [&](int it) {
    if (it < hi && valid[it]) {
      float* dst = bs + ((it - lo) & 1) * (kBM * BP);
#pragma unroll
      for (int e = 0; e < BEL; ++e) {
        int kk, nn;
        b_coord(e, kk, nn);
        // forward: row k at (k % 4) 16 + k / 4 (see the kernel's note)
        const int row = TRANS ? kk : ((kk & 3) << 4) | (kk >> 2);
        dst[row * BP + nn] = breg[e];
      }
    }
  };

  // four consecutive stored values of row r from column byte_col on (a
  // byte offset into a payload row; four times it into an fp32 row), times
  // the row's scale in the rowwise mode
  auto a_vals = [&](const unsigned char* st, int r, int byte_col,
                    float (&v)[4]) {
    if constexpr (PAY == kF32) {
      const float4 x = *reinterpret_cast<const float4*>(st + r * RB +
                                                        4 * byte_col);
      v[0] = x.x;
      v[1] = x.y;
      v[2] = x.z;
      v[3] = x.w;
    } else {
      word_to_f32x4<PAY>(
          *reinterpret_cast<const unsigned*>(st + r * RB + byte_col), v);
      if constexpr (SCALE == kRow) {
        const float s = reinterpret_cast<const float*>(st + kBM * RB)[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = __fmul_rn(v[j], s);
      }
    }
  };

  // d += this thread's share of A_tile @ B_slice
  auto mac = [&](const unsigned char* st, const float* bt, float (&d)[V]) {
    if constexpr (!TRANS) {
      // d[i TN + n] += sum_j A[4 og + i][4 rs + j] * B[4 rs + j][n]
      float av[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a_vals(st, 4 * og + i, 4 * rs, av[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* brow = bt + (16 * j + rs) * BP;
#pragma unroll
        for (int nn = 0; nn < TN; nn += 4) {
          const float4 bv = *reinterpret_cast<const float4*>(brow + nn);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float* dd = d + i * TN + nn;
            dd[0] = fmaf(av[i][j], bv.x, dd[0]);
            dd[1] = fmaf(av[i][j], bv.y, dd[1]);
            dd[2] = fmaf(av[i][j], bv.z, dd[2]);
            dd[3] = fmaf(av[i][j], bv.w, dd[3]);
          }
        }
      }
    } else {
      // d[jj TN + n] += sum_i A[16 i + rs][4 og + jj] * B[16 i + rs][n]
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 16 * i + rs;
        float av[4];
        a_vals(st, r, 4 * og, av);
        const float* brow = bt + r * BP;
#pragma unroll
        for (int nn = 0; nn < TN; nn += 4) {
          const float4 bv = *reinterpret_cast<const float4*>(brow + nn);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            float* dd = d + jj * TN + nn;
            dd[0] = fmaf(av[jj], bv.x, dd[0]);
            dd[1] = fmaf(av[jj], bv.y, dd[1]);
            dd[2] = fmaf(av[jj], bv.z, dd[2]);
            dd[3] = fmaf(av[jj], bv.w, dd[3]);
          }
        }
      }
    }
  };

  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;

  for (int s = 0; s < kStages - 1; ++s) issue_a(lo + s);
  load_b(lo);
  store_b(lo);

  for (int it = lo; it < hi; ++it) {
    cp_async_wait<kStages - 2>();  // this thread's copies of item `it` landed
    __syncthreads();               // everyone's copies and B stores visible;
                                   // item it-1's buffers are free again
    CK_IF(t == 0, groups, kRingA, kStages - 2);
    CK_IF(t == 0 && it > lo && valid[it - 1], release, kRingA,
          (it - 1 - lo) % kStages);
    issue_a(it + kStages - 1);
    load_b(it + 1);
    if (valid[it]) {
      CK_IF(t == 0, read, kRingA, (it - lo) % kStages);
      const unsigned char* st = ring + ((it - lo) % kStages) * STAGE;
      const float* bt = bs + ((it - lo) & 1) * (kBM * BP);
      if constexpr (SCALE == kBlock) {
        float part[V];
#pragma unroll
        for (int i = 0; i < V; ++i) part[i] = 0.f;
        mac(st, bt, part);
        const float s = *reinterpret_cast<const float*>(st + kBM * RB);
#pragma unroll
        for (int i = 0; i < V; ++i)
          acc[i] = __fadd_rn(acc[i], __fmul_rn(part[i], s));
      } else {
        mac(st, bt, acc);
      }
    }
    store_b(it + 1);
  }
  cp_async_wait<0>();
  CK_IF(t == 0, groups, kRingA, 0);

  // the chunk's sums: values base .. base + NV - 1 of this thread's V
  int base = 0;
  rs_round<V, 1, L>(acc, lane, base);
  auto coord = [&](int x, int& row, int& col) {
    const int idx = base + x;
    row = 4 * og + idx / TN;
    col = idx % TN;
  };
  const int count = ch.w;
  CK_IF(t == 0 && count == 1, gwrite, kOpC, c, c + row0 * n + n0, kBM,
        min(TN, n - n0), n);
  if (count == 1) {   // a run of one chunk: no partials
#pragma unroll
    for (int x = 0; x < NV; ++x) {
      int row, col;
      coord(x, row, col);
      if (n0 + col < n) store_as(&c[(row0 + row) * n + n0 + col], acc[x]);
    }
    return;
  }
  const long long tile_elems = kBM * TN;
  float* mine = work + (static_cast<long long>(blockIdx.y) * gridDim.x +
                        tile) * tile_elems;
  CK_IF(t == 0, gwrite, kOpWork, work, mine, 1, kBM * TN);
#pragma unroll
  for (int x = 0; x < NV; ++x) {
    int row, col;
    coord(x, row, col);
    mine[row * TN + col] = acc[x];
  }
  // the last block of the run to get here adds the run's partials
  __threadfence();
  __syncthreads();
  if (t == 0) {
    int* ctr = counters + static_cast<long long>(ch.z) * gridDim.x + tile;
    const int done = atomicAdd(ctr, 1);
    CK(counter, kOpCounters, ctr - counters, done, count);
    last = done == count - 1;
    if (last) *ctr = 0;   // ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* first = work + static_cast<long long>(ch.z) * gridDim.x *
                                  tile_elems + tile * tile_elems;
  const long long stride = static_cast<long long>(gridDim.x) * tile_elems;
  CK_IF(t == 0, gread, kOpWork, work, first, count, kBM * TN, stride);
  CK_IF(t == 0, gwrite, kOpC, c, c + row0 * n + n0, kBM, min(TN, n - n0), n);
#pragma unroll
  for (int x = 0; x < NV; ++x) {
    int row, col;
    coord(x, row, col);
    const int off = row * TN + col;
    float sum = __ldcg(first + off);
    for (int k = 1; k < count; ++k) sum += __ldcg(first + k * stride + off);
    if (n0 + col < n) store_as(&c[(row0 + row) * n + n0 + col], sum);
  }
}

struct Args {
  const void* a;
  const float* a_scales;
  const void* b;
  void* c;
  const int* slot_idx;
  const int* m_idx;
  const int* k_idx;
  const int* valid;
  const int* chunks;
  float* work;
  int* counters;
  int n_chunks;
  int n;
  long long sbk;
  long long sbn;
  cudaStream_t stream;
};

template <int TN, bool TRANS, int PAY, int SCALE, typename TO>
int launch(const Args& x) {
  constexpr size_t smem = smem_bytes<TN, PAY, SCALE>();
  auto kernel = segment_spmm_fold_kernel<TN, TRANS, PAY, SCALE, TO>;
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
  const dim3 grid((x.n + TN - 1) / TN, x.n_chunks);
  CK_LAUNCH("segment_spmm_fold_kernel", x.stream);
  kernel<<<grid, kThreads, smem, x.stream>>>(
      x.a, x.a_scales, static_cast<const __nv_bfloat16*>(x.b),
      static_cast<TO*>(x.c), x.slot_idx, x.m_idx, x.k_idx, x.valid,
      reinterpret_cast<const int4*>(x.chunks), x.work, x.counters, x.n,
      x.sbk, x.sbn);
  return static_cast<int>(cudaGetLastError());
}

template <bool TRANS, int PAY, int SCALE, typename TO>
int by_tile(int tile_n, const Args& x) {
  switch (tile_n) {
    case 4: return launch<4, TRANS, PAY, SCALE, TO>(x);
    case 8: return launch<8, TRANS, PAY, SCALE, TO>(x);
    case 16: return launch<16, TRANS, PAY, SCALE, TO>(x);
  }
  return -1;
}

template <bool TRANS, int PAY, int SCALE>
int by_out(int c_bf16, int tile_n, const Args& x) {
  return c_bf16 ? by_tile<TRANS, PAY, SCALE, __nv_bfloat16>(tile_n, x)
                : by_tile<TRANS, PAY, SCALE, float>(tile_n, x);
}

template <bool TRANS>
int by_payload(int payload, int scale_mode, int c_bf16, int tile_n,
               const Args& x) {
  if (payload == kF32 && scale_mode == kNone)
    return by_out<TRANS, kF32, kNone>(c_bf16, tile_n, x);
  if (payload == kI8 && scale_mode == kBlock)
    return by_out<TRANS, kI8, kBlock>(c_bf16, tile_n, x);
  if (payload == kI8 && scale_mode == kRow)
    return by_out<TRANS, kI8, kRow>(c_bf16, tile_n, x);
  if (payload == kF8 && scale_mode == kBlock)
    return by_out<TRANS, kF8, kBlock>(c_bf16, tile_n, x);
  if (payload == kF8 && scale_mode == kRow)
    return by_out<TRANS, kF8, kRow>(c_bf16, tile_n, x);
  return -1;
}

}  // namespace fold

// The dynamic shared memory of each launch, as a function of the launch's
// own parameters (-1 where the launchers make no launch).
bool known_mode(int payload, int scale_mode) {
  return payload == kF32 ? scale_mode == kNone
                         : (payload == kI8 || payload == kF8) &&
                               (scale_mode == kBlock || scale_mode == kRow);
}

template <int BM, bool TRANS, int PAY>
long long simt_smem(int tile_n) {
  switch (tile_n) {
    case 4: return smem_bytes<BM, BM, 4, TRANS, PAY>();
    case 8: return smem_bytes<BM, BM, 8, TRANS, PAY>();
    case 16: return smem_bytes<BM, BM, 16, TRANS, PAY>();
    case 32: return smem_bytes<BM, BM, 32, TRANS, PAY>();
  }
  return -1;
}

template <int BM, bool TRANS>
long long simt_smem(int payload, int tile_n) {
  if (payload == kF32) return simt_smem<BM, TRANS, kF32>(tile_n);
  if (payload == kI8) return simt_smem<BM, TRANS, kI8>(tile_n);
  return simt_smem<BM, TRANS, kF8>(tile_n);
}

template <int PAY, int SCALE>
long long split_smem(int tile_n) {
  switch (tile_n) {
    case 4: return fold::smem_bytes<4, PAY, SCALE>();
    case 8: return fold::smem_bytes<8, PAY, SCALE>();
    case 16: return fold::smem_bytes<16, PAY, SCALE>();
  }
  return -1;
}

}  // namespace

CK_NAMES("op:0:a op:1:a_scales op:2:b op:3:c op:4:slot_idx op:5:m_idx "
         "op:6:k_idx op:7:seg_start op:8:seg_write op:9:accum_prev "
         "op:10:valid op:11:runs op:12:work op:13:counters ring:0:a_tiles")

extern "C" {

// C[(grid_m*bm), n] (row-major, fp32 or bf16) = BSR(A) @ B, or BSR(A)^T @ B
// when trans != 0, under the plan's lane-major schedule.  A: (n_blocks, bm,
// bm), contiguous, 16-byte aligned, in the forward storage order in both
// modes; payload 0 = fp32, 1 = int8, 2 = fp8-e4m3.  a_scales: fp32, one per
// block (scale_mode 1) or one per block row, (n_blocks, bm) (scale_mode 2);
// null with scale_mode 0, which goes with fp32 blocks only.  B: (K, n) fp32
// or bf16 read at B[k * sbk + j * sbn].  run_off: n_runs + 1 offsets into
// the schedule arrays.  Returns 0, a cudaError_t value, or -1 for an
// unsupported block size, N tile, payload/scale combination or device index.
int segment_spmm(const void* a, const float* a_scales, const void* b,
                 void* c, const int* slot_idx, const int* m_idx,
                 const int* k_idx, const int* seg_start,
                 const int* seg_write, const int* accum_prev,
                 const int* valid, const int* run_off, int n_runs, int bm,
                 int n, long long sbk, long long sbn, int tile_n, int trans,
                 int payload, int scale_mode, int b_bf16, int c_bf16,
                 void* stream) {
  const Args x{a, a_scales, b, c, slot_idx, m_idx, k_idx, seg_start,
               seg_write, accum_prev, valid, run_off, n_runs, n, sbk, sbn,
               static_cast<cudaStream_t>(stream)};
  if (bm == 64)
    return by_mode<64>(trans, payload, scale_mode, b_bf16, c_bf16, tile_n, x);
  if (bm == 32)
    return by_mode<32>(trans, payload, scale_mode, b_bf16, c_bf16, tile_n, x);
  return -1;
}

// The folded kernel (64 x 64 blocks, bf16 B): C as above, from the plan's
// chunk table `chunks` ((n_chunks, 4) int32: first item, end, the run's
// first chunk, the run's chunk count), with `work` (n_chunks * ceil(n /
// tile_n) * 64 * tile_n fp32) for the partial sums and `counters` (at
// least n_chunks * ceil(n / tile_n) int32, zero, and left zero) for the
// arrivals.  tile_n is 4, 8 or 16.  Returns 0, a cudaError_t value, or -1
// for a call out of range.
int segment_spmm_split(const void* a, const float* a_scales, const void* b,
                       void* c, const int* slot_idx, const int* m_idx,
                       const int* k_idx, const int* seg_start,
                       const int* seg_write, const int* accum_prev,
                       const int* valid, const int* chunks, float* work,
                       int* counters, int n_chunks, int n, int tile_n,
                       long long sbk, long long sbn, int trans, int payload,
                       int scale_mode, int c_bf16, void* stream) {
  // the folded kernel sums each run's valid items whatever the flags say
  // (see the header), so it does not read them
  (void)seg_start;
  (void)seg_write;
  (void)accum_prev;
  if (n_chunks < 1 || n_chunks > 65535 || n < 1 ||
      reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(a_scales) % 16 ||
      reinterpret_cast<uintptr_t>(chunks) % 16)
    return -1;
  const fold::Args x{a, a_scales, b, c, slot_idx, m_idx, k_idx, valid,
                     chunks, work, counters, n_chunks, n, sbk, sbn,
                     static_cast<cudaStream_t>(stream)};
  return trans ? fold::by_payload<true>(payload, scale_mode, c_bf16, tile_n,
                                        x)
               : fold::by_payload<false>(payload, scale_mode, c_bf16, tile_n,
                                         x);
}

// Bytes of dynamic shared memory a segment_spmm launch asks for, by its
// block size, N tile, mode, payload and scale mode; -1 for a call the
// launcher refuses.  No launch.
long long segment_spmm_smem_bytes(int bm, int tile_n, int trans,
                                  int payload, int scale_mode) {
  if (!known_mode(payload, scale_mode)) return -1;
  if (bm == 64)
    return trans ? simt_smem<64, true>(payload, tile_n)
                 : simt_smem<64, false>(payload, tile_n);
  if (bm == 32)
    return trans ? simt_smem<32, true>(payload, tile_n)
                 : simt_smem<32, false>(payload, tile_n);
  return -1;
}

// The same for segment_spmm_split (the mode does not enter).
long long segment_spmm_split_smem_bytes(int tile_n, int payload,
                                        int scale_mode) {
  if (!known_mode(payload, scale_mode)) return -1;
  if (payload == kF32) return split_smem<kF32, kNone>(tile_n);
  if (payload == kI8)
    return scale_mode == kBlock ? split_smem<kI8, kBlock>(tile_n)
                                : split_smem<kI8, kRow>(tile_n);
  return scale_mode == kBlock ? split_smem<kF8, kBlock>(tile_n)
                              : split_smem<kF8, kRow>(tile_n);
}

const char* segment_spmm_error_string(int code) {
  if (code == -1)
    return "unsupported block size, N tile, payload/scale combination or "
           "device index";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
