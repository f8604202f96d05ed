// Faulty toy kernels, one per rule of the kernel analyzers, each the card's
// counterpart of a toy of tests/test_kernel_analysis.py, and twins that
// must analyze clean.  Built only in the checked variant
// (src/repro_torch/kernels/build.py's CHECKED_SOURCES); run by
// src/repro_torch/analysis/toys.py:
//
//   check_toy_race      two CTAs += into one global tile     parallel-race
//   check_toy_handoff   partials read by the last CTA of a counter (clean),
//                       or by CTA 1 with no counter          parallel-race
//   check_toy_oob       grid point 3 reads [24, 32) of 24    index-range
//   check_toy_ring      depth-2 ring reading the slot just issued
//                       (read_next) or the one waited on     ring-slot-war
//   check_toy_sem       an issue every step, a wait on even
//                       steps                                sem-balance
//   check_toy_vmem      a launch asking for `smem` bytes     vmem-budget
//
// The toys whose planted bug could stall an mbarrier wait with a bounded
// try_wait that returns (and logs), so a toy never hangs the context.
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

enum Op { kIn = 0, kOut = 1, kWork = 2, kCtr = 3 };
constexpr int kRing = 0;
constexpr int kSemSteps = 4;

// an mbarrier wait that gives up after ~2^20 cycles; tagged, it logs the
// wait whether or not the phase completed
__device__ __forceinline__ void bounded_wait(uint32_t bar, uint32_t parity,
                                             ck::Tag tag) {
  const long long t0 = clock64();
  while (clock64() - t0 < (1ll << 20)) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) break;
  }
#ifdef REPRO_CHECKED
  if (tag.on)
    ck::wait(tag.site, tag.ring, tag.slot, static_cast<int>(parity), tag.who);
#endif
}

// BUG: every CTA adds its row of `in` into the one tile `out`
__global__ void race_kernel(const float* in, float* out, int n) {
  CK_BEGIN();
  CK(operand, kIn, in, ck::kInput);
  CK(operand, kOut, out, ck::kOutput);
  const int t = threadIdx.x;
  CK_IF(t == 0, gread, kIn, in, in + blockIdx.x * n, 1, n);
  CK_IF(t == 0, gread, kOut, out, out, 1, n);
  CK_IF(t == 0, gwrite, kOut, out, out, 1, n);
  if (t < n) out[t] += in[blockIdx.x * n + t];
}

// CTA c writes its partial work[c]; with the counter the CTA that sees the
// last value sums them into out and resets it; without, CTA 1 reads them
// whether or not CTA 0 is done (BUG)
__global__ void handoff_kernel(const float* in, float* work, int* ctr,
                               float* out, int n, int use_counter) {
  CK_BEGIN();
  CK(operand, kIn, in, ck::kInput);
  CK(operand, kOut, out, ck::kOutput);
  CK(operand, kWork, work, ck::kWorkspace);
  CK(operand, kCtr, ctr, ck::kCounterOp);
  __shared__ int last;
  const int t = threadIdx.x;
  const int c = blockIdx.x;
  CK_IF(t == 0, gread, kIn, in, in + c * n, 1, n);
  CK_IF(t == 0, gwrite, kWork, work, work + c * n, 1, n);
  if (t < n) work[c * n + t] = 2.f * in[c * n + t];
  __threadfence();
  __syncthreads();
  if (t == 0) {
    if (use_counter) {
      const int seen = atomicAdd(ctr, 1);
      CK(counter, kCtr, 0, seen, gridDim.x);
      last = seen == gridDim.x - 1;
      if (last) *ctr = 0;
    } else {
      last = c == 1;
    }
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  CK_IF(t == 0, gread, kWork, work, work, 1, gridDim.x * n);
  CK_IF(t == 0, gwrite, kOut, out, out, 1, n);
  if (t < n) {
    float s = 0.f;
    for (int k = 0; k < gridDim.x; ++k) s += __ldcg(work + k * n + t);
    out[t] = s;
  }
}

// BUG: point i reads in[8 i, 8 i + 8) of a 24-element operand
__global__ void oob_kernel(const float* in, float* out) {
  CK_BEGIN();
  CK(operand, kIn, in, ck::kInput);
  CK(operand, kOut, out, ck::kOutput);
  const int i = blockIdx.x, t = threadIdx.x;
  CK_IF(t == 0, gread, kIn, in, in + 8 * i, 1, 8);
  CK_IF(t == 0, gwrite, kOut, out, out + 8 * i, 1, 8);
  if (t < 8) out[8 * i + t] = i < 3 ? in[8 * i + t] : 0.f;
}

// A depth-2 ring over n steps of 8 floats, thread 0 doing everything:
// step s issues step s + 1 into slot (s + 1) % 2, waits on slot s % 2 and
// reads slot s % 2, or (read_next, the BUG) slot (s + 1) % 2, whose copy
// was just issued
__global__ void ring_kernel(const float* in, float* out, int n,
                            int read_next) {
  __shared__ __align__(128) float buf[2][8];
  __shared__ __align__(8) uint64_t bars[2];
  CK_BEGIN();
  CK(operand, kIn, in, ck::kInput);
  CK(operand, kOut, out, ck::kOutput);
  CK(ring, kRing, 2, ck::kMbarrier);
  if (threadIdx.x != 0) return;
  const uint32_t full0 = smem_u32(&bars[0]);
  mbar_init(full0, 1);
  mbar_init(full0 + 8, 1);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  auto issue = [&](int step) {
    const int s = step % 2;
    mbar_expect_tx(full0 + 8 * s, 32, CK_TAG(true, kRing, s, 0));
    bulk_copy(smem_u32(buf[s]), in + 8 * step, 32, full0 + 8 * s,
              CK_COPY(true, kIn, in, 0));
  };
  issue(0);
  for (int step = 0; step < n; ++step) {
    if (step + 1 < n) issue(step + 1);
    const int s = step % 2;
    bounded_wait(full0 + 8 * s, (step / 2) & 1, CK_TAG(true, kRing, s, 0));
    const int r = read_next ? (step + 1) % 2 : s;
    CK(read, kRing, r);
    CK(gwrite, kOut, out, out + 8 * step, 1, 8);
    for (int j = 0; j < 8; ++j) out[8 * step + j] = buf[r][j];
    CK(release, kRing, r);
  }
  // drain: no copy may land after the block ends (untagged: not logged)
  for (int s = 0; s < 2; ++s)
    if (s < n) bounded_wait(full0 + 8 * s, ((n - 1 - s) / 2) & 1, ck::Tag{});
}

// BUG: a fill on every step (slot s of n, each on its own mbarrier), the
// wait only on even steps
__global__ void sem_kernel(const float* in, float* out, int n) {
  __shared__ __align__(128) float buf[kSemSteps][8];
  __shared__ __align__(8) uint64_t bars[kSemSteps];
  CK_BEGIN();
  CK(operand, kIn, in, ck::kInput);
  CK(operand, kOut, out, ck::kOutput);
  CK(ring, kRing, kSemSteps, ck::kMbarrier);
  if (threadIdx.x != 0 || n > kSemSteps) return;
  const uint32_t b0 = smem_u32(&bars[0]);
  for (int s = 0; s < n; ++s) mbar_init(b0 + 8 * s, 1);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  for (int step = 0; step < n; ++step) {
    mbar_expect_tx(b0 + 8 * step, 32, CK_TAG(true, kRing, step, 0));
    bulk_copy(smem_u32(buf[step]), in + 8 * step, 32, b0 + 8 * step,
              CK_COPY(true, kIn, in, 0));
    if (step % 2 == 0)
      bounded_wait(b0 + 8 * step, 0, CK_TAG(true, kRing, step, 0));
    CK(gwrite, kOut, out, out + 8 * step, 1, 8);
    for (int j = 0; j < 8; ++j) out[8 * step + j] = 1.f;
  }
  // drain: no copy may land after the block ends (untagged: not logged)
  for (int s = 0; s < n; ++s) bounded_wait(b0 + 8 * s, 0, ck::Tag{});
}

// a launch whose dynamic shared memory is what the caller asks
__global__ void vmem_kernel(const float* in, float* out, int n) {
  extern __shared__ float big[];
  CK_BEGIN();
  CK(operand, kIn, in, ck::kInput);
  CK(operand, kOut, out, ck::kOutput);
  const int t = threadIdx.x;
  CK_IF(t == 0, gread, kIn, in, in, 1, n);
  CK_IF(t == 0, gwrite, kOut, out, out, 1, n);
  if (t < n) {
    big[t] = in[t];
    out[t] = big[t];
  }
}

}  // namespace

CK_NAMES("op:0:in op:1:out op:2:work op:3:counter ring:0:buf")

extern "C" {

int check_toy_race(const float* in, float* out, int n, cudaStream_t stream) {
  CK_LAUNCH("race_kernel", stream);
  race_kernel<<<2, 128, 0, stream>>>(in, out, n);
  return static_cast<int>(cudaGetLastError());
}

int check_toy_handoff(const float* in, float* work, int* ctr, float* out,
                      int n, int use_counter, cudaStream_t stream) {
  CK_LAUNCH("handoff_kernel", stream);
  handoff_kernel<<<2, 128, 0, stream>>>(in, work, ctr, out, n, use_counter);
  return static_cast<int>(cudaGetLastError());
}

int check_toy_oob(const float* in, float* out, cudaStream_t stream) {
  CK_LAUNCH("oob_kernel", stream);
  oob_kernel<<<4, 32, 0, stream>>>(in, out);
  return static_cast<int>(cudaGetLastError());
}

int check_toy_ring(const float* in, float* out, int n, int read_next,
                   cudaStream_t stream) {
  CK_LAUNCH("ring_kernel", stream);
  ring_kernel<<<1, 32, 0, stream>>>(in, out, n, read_next);
  return static_cast<int>(cudaGetLastError());
}

int check_toy_sem(const float* in, float* out, int n, cudaStream_t stream) {
  CK_LAUNCH("sem_kernel", stream);
  sem_kernel<<<1, 32, 0, stream>>>(in, out, n);
  return static_cast<int>(cudaGetLastError());
}

int check_toy_vmem(const float* in, float* out, int n, int smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      vmem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  CK_LAUNCH("vmem_kernel", stream);
  vmem_kernel<<<1, 128, smem, stream>>>(in, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
