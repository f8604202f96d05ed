// What the tensor-core paths of flash_attention.cu and
// flash_attention_bwd.cu share: the exact split of fp32 values into bf16
// parts (in registers and as a pre-pass over an operand), the order of the
// split's passes, the bf16 wgmma shapes they run, and the tensor map of a
// split operand.  Included after hopper.cuh.
#pragma once

#include "hopper.cuh"

namespace {

// ---- the exact bf16 split --------------------------------------------------

// the passes (part of the left operand, part of the right one) with i + j
// <= 2, smallest first (kernels/flash_attention.py::tc_passes)
__host__ __device__ constexpr int pass_a(int ps) {
  return ps == 0 ? 2 : ps == 1 ? 1 : ps == 2 ? 0 : ps == 3 ? 1 : 0;
}
__host__ __device__ constexpr int pass_b(int ps) {
  return ps == 0 ? 0 : ps == 1 ? 1 : ps == 2 ? 2 : ps == 3 ? 0 : ps == 4 ? 1
                                                                       : 0;
}
// the first pass that runs for operands of na and nb parts
__host__ __device__ constexpr int first_pass(int na, int nb) {
  int ps = 0;
  while (ps < 5 && !(pass_a(ps) < na && pass_b(ps) < nb)) ++ps;
  return ps;
}

// the pair (v0, v1) as NP bf16 parts: hi = bf16(v), then the rest, each
// part rounded from what the earlier ones leave (three: exact)
template <int NP>
__device__ __forceinline__ void split_pair(float v0, float v1,
                                           uint32_t (&out)[NP]) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    out[i] = bits(h);
    if (i + 1 < NP) {
      const float2 hf = __bfloat1622float2(h);
      v0 = __fsub_rn(v0, hf.x);
      v1 = __fsub_rn(v1, hf.y);
    }
  }
}

// the exact split of fp32 values into bf16 hi, mid, lo (parts at 0, n, 2 n)
__global__ void split3_kernel(const float4* __restrict__ x,
                              uint2* __restrict__ parts, long long n4) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n4; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float4 a = x[i];
    uint32_t w0[3], w1[3];
    split_pair<3>(a.x, a.y, w0);
    split_pair<3>(a.z, a.w, w1);
    parts[i] = make_uint2(w0[0], w1[0]);
    parts[n4 + i] = make_uint2(w0[1], w1[1]);
    parts[2 * n4 + i] = make_uint2(w0[2], w1[2]);
  }
}

// a bf16 operand of a mixed call: itself and two zero parts
__global__ void split3_bf16_kernel(const uint2* __restrict__ x,
                                   uint2* __restrict__ parts, long long n4) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n4; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    parts[i] = x[i];
    parts[n4 + i] = make_uint2(0u, 0u);
    parts[2 * n4 + i] = make_uint2(0u, 0u);
  }
}

// ---- bf16 wgmma ------------------------------------------------------------

// d (64 x 64 fp32, 32 registers a thread) = A @ B (+ d when accumulate):
// bf16 A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}
// d (64 x 32 fp32, 16 registers a thread), the same
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a,
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (N == 64) {
    wgmma_ss_n64(d, da, db, accumulate);
  } else {
    wgmma_ss_n32(d, da, db, accumulate);
  }
}
// d (64 x 64 fp32) = A @ B (+ d when accumulate): bf16 A from registers
// (the m16n8k16 A fragment of each warp's 16 rows), B from shared memory,
// MN-major (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

// ---- host ------------------------------------------------------------------

// bf16 (planes, t, d) as a 3-D map, innermost first: (d, t, planes); boxes
// of 64 columns x `rows` rows x 1 plane, 128-byte swizzle, zeros past d
// and t
bool encode3d(CUtensorMap* map, const void* ptr, int d, int t,
              long long planes, int rows) {
  EncodeTiled fn = encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(d) * t * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// an operand of n values (fp32, or bf16 when is_bf16) to its three bf16
// parts at `dst`
int split3(const void* src, int is_bf16, void* dst, long long n,
           cudaStream_t stream) {
  const long long n4 = n / 4;
  const long long b = (n4 + 255) / 256;
  const unsigned blocks = static_cast<unsigned>(b < 8192 ? b : 8192);
  if (is_bf16)
    split3_bf16_kernel<<<blocks, 256, 0, stream>>>(
        static_cast<const uint2*>(src), static_cast<uint2*>(dst), n4);
  else
    split3_kernel<<<blocks, 256, 0, stream>>>(
        static_cast<const float4*>(src), static_cast<uint2*>(dst), n4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
