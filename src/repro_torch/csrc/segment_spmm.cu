// Segment-scheduled block-sparse x dense matmul: C = BSR(A) @ B (forward)
// or C = BSR(A)^T @ B (transpose_lhs, the backward pass's dx = W^T @ dy).
//
// Replaces the TPU kernel src/repro/kernels/segment_spmm.py::segment_spmm
// (forward and transpose_lhs modes; fp32 blocks, and int8 / fp8-e4m3
// payloads with per-block or rowwise fp32 scales).  Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a library with the plain C interface at the bottom of this file,
// loaded from Python with ctypes (src/repro_torch/kernels/build.py).
//
// Work decomposition.  The TPU grid walks one lane per core and keeps a C
// tile in VMEM across consecutive items of the same output block row.  On
// the GPU a lane is far too little parallelism (the sparse FFN plans one
// lane), but the planner keeps every output block row (its "owner run":
// all of its items, folded continuations included) contiguous inside one
// lane.  So this kernel launches one thread block per (N tile, owner run):
// the run's items are walked in schedule order by that block alone, which is
// exact and needs no atomics.  The wrapper derives the run offsets once per
// plan.  N tiles are the fast grid axis, so the tiles of one run run back
// to back and share its A tiles in L2.
//
// Per item the block follows the plan's flags as the TPU kernel does:
// zero the fp32 accumulator at seg_start, reload it from C at accum_prev
// (folded continuation: the same thread wrote that element at the
// segment's earlier seg_write), add A_tile @ B_slice when valid, store at
// seg_write.  Pad items (valid == 0) carry no flags and move no data.
//
// Transposed mode.  The backward plan (the planner's grad_plan) schedules
// W^T's block rows, but its slot_idx addresses the forward weight storage,
// so each item contracts the stored tile along its row axis: C rows are the
// stored tile's columns.  Nothing is transposed in memory.  The A tile lands
// in shared memory as in the forward mode; what changes is which C rows a
// thread owns.  Forward, a thread owns rows interleaved across the tile and
// reads float4s along k of each A row.  Transposed, it owns P contiguous
// rows, which are P contiguous words of one stored A row, so it reads them
// with vector loads; the threads of a warp that share a row group read the
// same words (a broadcast) and different groups read neighbouring words, so
// the reads are free of bank conflicts and no shared-memory transpose (and
// no extra barrier) is needed.
//
// Data movement.  A tiles (bm x bk, addressed through slot_idx in BSR
// storage order) stream through a 3-stage shared-memory ring filled with
// cp.async, so the next two tiles are in flight while one is multiplied.
// fp32 tiles land in the ring as the fp32 tiles the inner loop reads.
// Quantized payloads move as they are, 1 byte an element (a quarter of the
// fp32 bytes: what the quantized modes buy at decode widths): the ring holds
// the raw bytes, and after the item's barrier the threads that copied them
// convert them, 16 bytes (one uint4 read) each, into one fp32 tile in shared
// memory, which a second barrier publishes; the inner loop is then the
// fp32 one in every mode, forward and transposed alike.  int8 converts by
// sign extension; e4m3 converts in pairs through the fp8x2 -> f16x2
// conversion (exact: every e4m3 value is a half), then to fp32.
// The B slice (contraction x tile_n) of the next item is loaded into
// registers during the current item's arithmetic and stored to a second
// shared buffer after it.  N tiles are 4..32 wide: a 64-wide tile needs 16
// accumulators and 16 staged B values a thread and spills at 255 registers.
// B is read by stride, so the sparse FFN's B = x.T (a transposed view,
// k-contiguous) and the backward pass's dy (also a transposed view) need no
// copy; the loader lets neighbouring threads walk whichever axis has unit
// stride.  The ragged N edge is masked here, so B is never padded.
//
// Numerics.  Accumulation is fp32 on the CUDA cores (fmaf), never TF32 mma,
// to keep fp32 parity with the reference.  B may be fp32 or bf16 (converted
// to fp32 on load); C is written as fp32 or bf16.  Quantized payloads keep
// the TPU kernel's order.  Rowwise scales index the stored tile's rows,
// which are the contraction axis under transpose_lhs, so they do not factor
// out of the product: each element is multiplied by its row's scale when
// the fp32 tile is made, before the product, in both modes.  A per-block
// scale is a scalar of the tile: the item's product is summed into its own
// registers, multiplied by the scale and then added to the accumulator
// (both roundings kept, no fused multiply-add), as contrib * scale is added
// in the TPU kernel.
//
// Bound.  At decode widths (N = 4) the kernel must read every stored A
// tile once: 3200 tiles of 64x64 fp32 = 52.4 MB per FFN projection, which is
// 15.7 us at 3.35 TB/s, so bytes bind; an int8/fp8 payload is 13.1 MB plus
// 12.8 KB of per-block scales (819 KB rowwise), 4.0-4.2 us.  At N = 64 the
// 1.68 GFLOP against the 67 TFLOP/s fp32 CUDA-core peak (25 us) binds, and
// at the training width (N = 2048) the 53.7 GFLOP of one projection bind at
// 0.80 ms, in either mode.  The cp.async ring keeps ~3 A tiles of each block
// in flight for the first; the register-blocked inner loop (vector A reads,
// one B value reused across a thread's rows) serves the others.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace {

constexpr int kStages = 3;       // depth of the A-tile ring
constexpr int kMaxDevices = 64;

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

  auto issue_a = [&](int it) {
    if (it < hi && valid[it]) {
      unsigned char* dst = ring + ((it - lo) % kStages) * RING;
      const long long slot = slot_idx[it];
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
    cp_async_commit();  // empty groups keep the wait count uniform
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
    issue_a(it + kStages - 1);
    load_b(it + 1);
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
        const float s = a_scales[slot_idx[it]];
#pragma unroll
        for (int i = 0; i < P; ++i)
          acc[i] = __fadd_rn(acc[i], __fmul_rn(part[i], s));
      } else {
        mac(at, bt, acc);
      }
    }
    if (seg_write[it] && col_ok) {
#pragma unroll
      for (int i = 0; i < P; ++i)
        store_as(&c[(row0 + out_row(i)) * n + n0 + col], acc[i]);
    }
    store_b(it + 1);
  }
  cp_async_wait<0>();
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
  if (b_bf16 && !c_bf16)
    return by_tile<BM, TRANS, PAY, SCALE, bf16, float>(tile_n, x);
  return by_tile<BM, TRANS, PAY, SCALE, bf16, bf16>(tile_n, x);
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

}  // namespace

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

const char* segment_spmm_error_string(int code) {
  if (code == -1)
    return "unsupported block size, N tile, payload/scale combination or "
           "device index";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
