// Segment-scheduled block-sparse x block-sparse matmul (the numeric SpGEMM
// phase) on the CUDA cores: the C blocks of BSR(A) @ BSR(B) at the
// symbolic pattern, under the plan's lane-major list of (a_idx, b_idx,
// c_idx) block triples.  The "simt" path of the wrapper
// (src/repro_torch/kernels/segment_spgemm.py): 32-wide and non-square
// tiles, and, when asked, 64 x 64 ones, which take the tensor-core kernel
// of segment_spgemm_tc.cu by default.
//
// Replaces the TPU kernel src/repro/kernels/segment_spgemm.py::segment_spgemm
// (fp32 blocks, and int8 / fp8-e4m3 payloads with per-block or rowwise fp32
// scales on both operands).  Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a library with the plain C interface at the bottom of this file,
// loaded from Python with ctypes (src/repro_torch/kernels/build.py).
//
// Work decomposition.  The TPU grid walks one lane per core and keeps the C
// tile in VMEM across the items of one C block.  The planner keeps every C
// block's items (its "owner run": the whole chain, folded continuations
// included) contiguous inside one lane, so this kernel launches one thread
// block per owner run; the block walks the run's items in schedule order,
// which is exact without atomics.  Every symbolic C block has at least one
// item, so every C block is written and no dead-block masking is needed.
// Per item the block follows the plan's flags as the TPU kernel does: zero
// the fp32 accumulator at seg_start, reload it from C at accum_prev (a folded
// continuation: the same thread stored those elements at the segment's
// earlier seg_write), add A[a_idx] @ B[b_idx] when valid, store at
// seg_write.  Pad items (valid == 0) carry no flags and move no data.
//
// Data movement.  A tiles bm x bk and B tiles bk x bn, each of bm, bk, bn
// 32 or 64 (eight shapes).  The A and B tiles of
// the next two items are in flight in a 3-stage shared-memory ring filled
// with cp.async while one item is multiplied.  Payload bytes move as they
// are (4 bytes an element for fp32, 1 for int8 and fp8): that is what makes
// the quantized modes cheaper in bytes.  A quantized item's two tiles are
// then converted once, by the threads that copied them, into fp32 tiles in
// shared memory (1/64 of the item's arithmetic), so one fp32 inner loop
// serves every mode.
//
// Arithmetic.  bm*bn/16 threads; a thread owns a 4 x 4 block of C: rows
// ty + (bm/4) i (interleaved, so the two or four rows a warp reads from the
// padded A tile fall in different banks) and columns 4 tx .. 4 tx + 3 (one
// float4 of each B row, shared by the threads of a row group).  Each step
// of 4 along k reads 4 float4s of A and 4 of B and does 64 FMAs into the
// item's product p, all fp32 on the CUDA cores (fmaf), never TF32.
//
// Numerics follow the TPU kernel's order.  Rowwise scales (A rows -> C
// rows, B rows -> the contraction axis) do not factor out of the product:
// each payload element is converted to fp32 and multiplied by its row's
// scale when the fp32 tile is made, before the product.  Per-block scales
// are scalars of the tile: p = (p * a_scale) * b_scale after the product,
// before p is added to the accumulator.  C is written as fp32 or bf16.
//
// Bound.  At granite-3-8b's FFN shapes (64 x 64 blocks at 25 % density)
// the work is data-dependent: 2 * 64^3 operations per triple.  (4096 x
// 12800) @ (12800 x 4096) has 50,311 triples, 26.4 GFLOP: 0.39 ms at the
// 67 TFLOP/s fp32 CUDA-core peak, against ~0.05 ms for its 171 MB of tiles
// and C; (12800 x 4096) @ (4096 x 12800) has 157,631 triples, 82.6 GFLOP
// (1.23 ms) and a 644 MB C (0.19 ms).  Operations bind; the register-blocked
// 4 x 4 loop (two float4 reads per 8 FMAs) serves that, and the ring hides
// the tile loads behind it.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kStages = 3;       // depth of the tile ring
constexpr int kMaxDevices = 64;
// the checked build's operands and ring (check.cuh); the schedule arrays
// are numbered in their argument order from kOpAIdx on
enum CkOp {
  kOpA = 0, kOpB, kOpC, kOpAScales, kOpBScales, kOpAIdx, kOpBIdx, kOpCIdx,
  kOpStart, kOpWrite, kOpPrev, kOpValid, kOpRuns
};
constexpr int kRingT = 0;   // a stage: A's tile and B's

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

// one payload byte to fp32 (exact for both types)
template <int PAY>
__device__ __forceinline__ float byte_to_f32(unsigned char x) {
  if constexpr (PAY == kI8) {
    return static_cast<float>(static_cast<signed char>(x));
  } else {
    __nv_fp8_e4m3 v;
    v.__x = x;
    return static_cast<float>(v);
  }
}

// Shared memory, in bytes: fp32 tiles are A [BM][BK + 4] (padded rows)
// and B [BK][BN].  fp32 payloads: the ring holds those tiles.  1-byte
// payloads: the ring holds the raw bytes of both, and one fp32 A and B
// tile follow it.
template <int BM, int BK, int BN, int PAY>
constexpr size_t smem_bytes() {
  constexpr size_t f32_tiles =
      sizeof(float) * (size_t(BM) * (BK + 4) + size_t(BK) * BN);
  if constexpr (PAY == kF32) return kStages * f32_tiles;
  return kStages * (size_t(BM) * BK + size_t(BK) * BN) + f32_tiles;
}

// One thread block per owner run; BM*BN/16 threads.
template <int BM, int BK, int BN, int PAY, int SCALE, typename TO>
__global__ void __launch_bounds__(BM * BN / 16) segment_spgemm_kernel(
    const void* __restrict__ a, const void* __restrict__ b, TO* c,
    const float* __restrict__ a_scales, const float* __restrict__ b_scales,
    const int* __restrict__ a_idx, const int* __restrict__ b_idx,
    const int* __restrict__ c_idx, const int* __restrict__ seg_start,
    const int* __restrict__ seg_write, const int* __restrict__ accum_prev,
    const int* __restrict__ valid, const int* __restrict__ run_off) {
  constexpr int THREADS = BM * BN / 16;
  constexpr int AP = BK + 4;           // padded fp32 A row, 16-byte aligned
  constexpr int QM = BM / 4;           // row groups
  constexpr int QN = BN / 4;           // threads per C row group
  constexpr int ESZ = PAY == kF32 ? 4 : 1;   // payload bytes an element
  constexpr int A_BYTES = BM * BK * ESZ;
  constexpr int B_BYTES = BK * BN * ESZ;
  static_assert(THREADS == QM * QN, "bad tile");
  static_assert(PAY != kF32 || SCALE == kNone, "fp32 tiles take no scales");

  extern __shared__ __align__(16) unsigned char smem[];
  // fp32 payloads: stage s holds A (padded rows) and B after it.  1-byte
  // payloads: stage s holds A's and B's bytes; the fp32 tiles follow.
  constexpr int STAGE = PAY == kF32
                            ? int(sizeof(float)) * (BM * AP + BK * BN)
                            : A_BYTES + B_BYTES;
  float* a32 = reinterpret_cast<float*>(smem + kStages * STAGE);
  float* b32 = a32 + BM * AP;

  const int t = threadIdx.x;
  const int tx = t % QN;
  const int ty = t / QN;
  const int lo = run_off[blockIdx.x];
  const int hi = run_off[blockIdx.x + 1];
  TO* ct = c + static_cast<long long>(c_idx[lo]) * (BM * BN);
  auto c_at = [&](int i, int j) {
    return ct + (ty + QM * i) * BN + 4 * tx + j;
  };
  CK_BEGIN();
  CK(operand, kOpA, static_cast<const unsigned char*>(a), ck::kInput);
  CK(operand, kOpB, static_cast<const unsigned char*>(b), ck::kInput);
  CK(operand, kOpC, c, ck::kOutput);
  CK(operand, kOpAScales, a_scales, ck::kInput);
  CK(operand, kOpBScales, b_scales, ck::kInput);
  CK(operand_each, kOpAIdx, ck::kInput, a_idx, b_idx, c_idx, seg_start,
     seg_write, accum_prev, valid);
  CK(operand, kOpRuns, run_off, ck::kInput);
  CK(ring, kRingT, kStages, ck::kGroups);
  CK_IF(t == 0, gread, kOpRuns, run_off, run_off + blockIdx.x, 1, 2);
  CK_IF(t == 0, gread, kOpCIdx, c_idx, c_idx + lo, 1, 1);
  CK_IF(t == 0, gread_each, kOpAIdx, lo, hi - lo, a_idx, b_idx, c_idx,
        seg_start, seg_write, accum_prev, valid);

  auto issue = [&](int it) {
    if (it < hi && valid[it]) {
      unsigned char* st = smem + ((it - lo) % kStages) * STAGE;
      const unsigned char* sa = static_cast<const unsigned char*>(a) +
                                static_cast<long long>(a_idx[it]) * A_BYTES;
      const unsigned char* sb = static_cast<const unsigned char*>(b) +
                                static_cast<long long>(b_idx[it]) * B_BYTES;
      CK_IF(t == 0, issue, kRingT, (it - lo) % kStages);
      CK_IF(t == 0, gread, kOpA, static_cast<const unsigned char*>(a), sa, 1,
            A_BYTES);
      CK_IF(t == 0, gread, kOpB, static_cast<const unsigned char*>(b), sb, 1,
            B_BYTES);
      for (int idx = t; idx < A_BYTES / 16; idx += THREADS) {
        if constexpr (PAY == kF32) {
          const int r = idx / (BK / 4);
          const int c4 = (idx % (BK / 4)) * 4;
          cp_async16(reinterpret_cast<float*>(st) + r * AP + c4, sa + idx * 16);
        } else {
          cp_async16(st + idx * 16, sa + idx * 16);
        }
      }
      unsigned char* sbt = PAY == kF32 ? st + sizeof(float) * BM * AP
                                       : st + A_BYTES;
      for (int idx = t; idx < B_BYTES / 16; idx += THREADS)
        cp_async16(sbt + idx * 16, sb + idx * 16);
    }
    // empty groups keep the wait count uniform
    cp_async_commit(CK_TAG(t == 0, kRingT, 0, 0));
  };

  // 1-byte payloads: the 16-element chunks this thread copied, to fp32
  // (times their row's scale in the rowwise mode)
  auto dequant = [&](int it) {
    const unsigned char* st = smem + ((it - lo) % kStages) * STAGE;
    CK_IF(t == 0 && SCALE == kRow, gread, kOpAScales, a_scales,
          a_scales + static_cast<long long>(a_idx[it]) * BM, 1, BM);
    CK_IF(t == 0 && SCALE == kRow, gread, kOpBScales, b_scales,
          b_scales + static_cast<long long>(b_idx[it]) * BK, 1, BK);
    for (int idx = t; idx < A_BYTES / 16; idx += THREADS) {
      const int e0 = idx * 16;
      const int r = e0 / BK;
      const int k0 = e0 % BK;
      float s = 1.f;
      if constexpr (SCALE == kRow)
        s = a_scales[static_cast<long long>(a_idx[it]) * BM + r];
      float v[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        v[j] = byte_to_f32<PAY>(st[e0 + j]);
        if constexpr (SCALE == kRow) v[j] *= s;
      }
#pragma unroll
      for (int j = 0; j < 16; j += 4)
        *reinterpret_cast<float4*>(a32 + r * AP + k0 + j) =
            make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    }
    for (int idx = t; idx < B_BYTES / 16; idx += THREADS) {
      const int e0 = idx * 16;
      const int r = e0 / BN;
      float s = 1.f;
      if constexpr (SCALE == kRow)
        s = b_scales[static_cast<long long>(b_idx[it]) * BK + r];
      float v[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        v[j] = byte_to_f32<PAY>(st[A_BYTES + e0 + j]);
        if constexpr (SCALE == kRow) v[j] *= s;
      }
#pragma unroll
      for (int j = 0; j < 16; j += 4)
        *reinterpret_cast<float4*>(b32 + e0 + j) =
            make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < kStages - 1; ++s) issue(lo + s);

  for (int it = lo; it < hi; ++it) {
    cp_async_wait<kStages - 2>();  // this thread's copies of item `it` landed
    __syncthreads();               // everyone's copies visible; item it-1's
                                   // ring slot and fp32 tiles are free again
    CK_IF(t == 0, groups, kRingT, kStages - 2);
    CK_IF(t == 0 && it > lo && valid[it - 1], release, kRingT,
          (it - 1 - lo) % kStages);
    issue(it + kStages - 1);
    const bool live = valid[it] != 0;
    CK_IF(t == 0 && live, read, kRingT, (it - lo) % kStages);
    const float* at;
    const float* bt;
    if constexpr (PAY == kF32) {
      at = reinterpret_cast<const float*>(smem + ((it - lo) % kStages) * STAGE);
      bt = at + BM * AP;
    } else {
      if (live) dequant(it);
      __syncthreads();
      at = a32;
      bt = b32;
    }

    if (seg_start[it]) {
      CK_IF(t == 0 && accum_prev[it], gread, kOpC, c, ct, 1, BM * BN);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = accum_prev[it] ? to_f32(*c_at(i, j)) : 0.f;
    }
    if (live) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) p[i][j] = 0.f;
#pragma unroll 4
      for (int k = 0; k < BK; k += 4) {
        float av[4][4], bv[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 q =
              *reinterpret_cast<const float4*>(at + (ty + QM * i) * AP + k);
          av[i][0] = q.x;
          av[i][1] = q.y;
          av[i][2] = q.z;
          av[i][3] = q.w;
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 q =
              *reinterpret_cast<const float4*>(bt + (k + kk) * BN + 4 * tx);
          bv[kk][0] = q.x;
          bv[kk][1] = q.y;
          bv[kk][2] = q.z;
          bv[kk][3] = q.w;
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              p[i][j] = fmaf(av[i][kk], bv[kk][j], p[i][j]);
      }
      float sa = 1.f, sb = 1.f;
      if constexpr (SCALE == kBlock) {
        CK_IF(t == 0, gread, kOpAScales, a_scales, a_scales + a_idx[it], 1, 1);
        CK_IF(t == 0, gread, kOpBScales, b_scales, b_scales + b_idx[it], 1, 1);
        sa = a_scales[a_idx[it]];
        sb = b_scales[b_idx[it]];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float v = p[i][j];
          if constexpr (SCALE == kBlock) v = (v * sa) * sb;
          acc[i][j] += v;
        }
    }
    CK_IF(t == 0 && seg_write[it], gwrite, kOpC, c, ct, 1, BM * BN);
    if (seg_write[it]) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (sizeof(TO) == 4) {
          *reinterpret_cast<float4*>(c_at(i, 0)) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) store_as(c_at(i, j), acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();
  CK_IF(t == 0, groups, kRingT, 0);
}

struct Args {
  const void* a;
  const void* b;
  void* c;
  const float* a_scales;
  const float* b_scales;
  const int* a_idx;
  const int* b_idx;
  const int* c_idx;
  const int* seg_start;
  const int* seg_write;
  const int* accum_prev;
  const int* valid;
  const int* run_off;
  int n_runs;
  cudaStream_t stream;
};

template <int BM, int BK, int BN, int PAY, int SCALE, typename TO>
int launch(const Args& x) {
  constexpr size_t smem = smem_bytes<BM, BK, BN, PAY>();
  auto kernel = segment_spgemm_kernel<BM, BK, BN, PAY, SCALE, TO>;
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
  CK_LAUNCH("segment_spgemm_kernel", x.stream);
  kernel<<<x.n_runs, BM * BN / 16, smem, x.stream>>>(
      x.a, x.b, static_cast<TO*>(x.c), x.a_scales, x.b_scales, x.a_idx,
      x.b_idx, x.c_idx, x.seg_start, x.seg_write, x.accum_prev, x.valid,
      x.run_off);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BK, int BN, typename TO>
int by_mode(int payload, int scale_mode, const Args& x) {
  if (payload == kF32 && scale_mode == kNone)
    return launch<BM, BK, BN, kF32, kNone, TO>(x);
  if (payload == kI8 && scale_mode == kBlock)
    return launch<BM, BK, BN, kI8, kBlock, TO>(x);
  if (payload == kI8 && scale_mode == kRow)
    return launch<BM, BK, BN, kI8, kRow, TO>(x);
  if (payload == kF8 && scale_mode == kBlock)
    return launch<BM, BK, BN, kF8, kBlock, TO>(x);
  if (payload == kF8 && scale_mode == kRow)
    return launch<BM, BK, BN, kF8, kRow, TO>(x);
  return -1;
}

template <int BM, int BK, int BN>
int by_out(int payload, int scale_mode, int c_bf16, const Args& x) {
  return c_bf16 ? by_mode<BM, BK, BN, __nv_bfloat16>(payload, scale_mode, x)
                : by_mode<BM, BK, BN, float>(payload, scale_mode, x);
}

// each of bm, bk, bn is 32 or 64
template <int BM, int BK>
int by_bn(int bn, int payload, int scale_mode, int c_bf16, const Args& x) {
  if (bn == 32) return by_out<BM, BK, 32>(payload, scale_mode, c_bf16, x);
  if (bn == 64) return by_out<BM, BK, 64>(payload, scale_mode, c_bf16, x);
  return -1;
}

template <int BM>
int by_bk(int bk, int bn, int payload, int scale_mode, int c_bf16,
          const Args& x) {
  if (bk == 32) return by_bn<BM, 32>(bn, payload, scale_mode, c_bf16, x);
  if (bk == 64) return by_bn<BM, 64>(bn, payload, scale_mode, c_bf16, x);
  return -1;
}

// the shared memory of the launch by_bk makes (the scale mode does not
// enter it)
template <int BM, int BK, int BN>
long long smem_by_payload(int payload) {
  if (payload == kF32) return smem_bytes<BM, BK, BN, kF32>();
  if (payload == kI8) return smem_bytes<BM, BK, BN, kI8>();
  return smem_bytes<BM, BK, BN, kF8>();
}

template <int BM, int BK>
long long smem_by_bn(int bn, int payload) {
  if (bn == 32) return smem_by_payload<BM, BK, 32>(payload);
  if (bn == 64) return smem_by_payload<BM, BK, 64>(payload);
  return -1;
}

template <int BM>
long long smem_by_bk(int bk, int bn, int payload) {
  if (bk == 32) return smem_by_bn<BM, 32>(bn, payload);
  if (bk == 64) return smem_by_bn<BM, 64>(bn, payload);
  return -1;
}

}  // namespace

CK_NAMES("op:0:a op:1:b op:2:c op:3:a_scales op:4:b_scales op:5:a_idx "
         "op:6:b_idx op:7:c_idx op:8:seg_start op:9:seg_write "
         "op:10:accum_prev op:11:valid op:12:runs ring:0:tiles")

extern "C" {

// C (n_c_blocks, bm, bn), row-major, fp32 or bf16 = the C blocks of
// BSR(A) @ BSR(B) under the plan's lane-major triple schedule.  A (na, bm,
// bk) and B (nb, bk, bn), each of bm, bk, bn 32 or 64: contiguous, 16-byte
// aligned; payload 0 = fp32, 1 = int8, 2 = fp8-e4m3; scale_mode 0 = none
// (fp32 only), 1 = one fp32 scale per block, 2 = one per block row
// (a_scales (na, bm), b_scales (nb, bk)).  run_off: n_runs + 1 offsets into
// the schedule arrays, one run per C block.  Returns 0, a cudaError_t
// value, or -1 for an unsupported tile, payload/scale combination or
// device index.
int segment_spgemm(const void* a, const void* b, void* c,
                   const float* a_scales, const float* b_scales,
                   const int* a_idx, const int* b_idx, const int* c_idx,
                   const int* seg_start, const int* seg_write,
                   const int* accum_prev, const int* valid,
                   const int* run_off, int n_runs, int bm, int bk, int bn,
                   int payload, int scale_mode, int c_bf16, void* stream) {
  const Args x{a, b, c, a_scales, b_scales, a_idx, b_idx, c_idx, seg_start,
               seg_write, accum_prev, valid, run_off, n_runs,
               static_cast<cudaStream_t>(stream)};
  if (bm == 64) return by_bk<64>(bk, bn, payload, scale_mode, c_bf16, x);
  if (bm == 32) return by_bk<32>(bk, bn, payload, scale_mode, c_bf16, x);
  return -1;
}

// Bytes of dynamic shared memory a segment_spgemm launch asks for, by its
// tile shape, payload and scale mode; -1 for a call the launcher refuses.
// No launch.
long long segment_spgemm_smem_bytes(int bm, int bk, int bn, int payload,
                                    int scale_mode) {
  if (payload == kF32 ? scale_mode != kNone
                      : (payload != kI8 && payload != kF8) ||
                            (scale_mode != kBlock && scale_mode != kRow))
    return -1;
  if (bm == 64) return smem_by_bk<64>(bk, bn, payload);
  if (bm == 32) return smem_by_bk<32>(bk, bn, payload);
  return -1;
}

const char* segment_spgemm_error_string(int code) {
  if (code == -1)
    return "unsupported tile, payload/scale combination or device index";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
