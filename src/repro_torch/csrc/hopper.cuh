// Hopper building blocks that the kernels of this directory share: the
// mbarrier, TMA, bulk-copy and cp.async primitives of a load ring, the
// wgmma instructions and their shared-memory descriptors, setmaxnreg, and
// the tensor-map encoder (cuTensorMapEncodeTiled).  Each source is
// compiled alone into its own library (src/repro_torch/kernels/build.py);
// this header is included by each and keeps everything in the including
// file's unnamed namespace.
//
// The ring primitives take a trailing ck::Tag (check.cuh): in the checked
// build a tag made with CK_TAG logs the event (an expect_tx is a slot's
// issue, a completed wait its wait, an arrive its release, a TMA box or a
// bulk copy its global read); in the release build the tag is empty and
// the primitive is what it was.
#pragma once

#include <cuda.h>          // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "check.cuh"

namespace ck {
#ifdef REPRO_CHECKED
// a TMA box's operand and extents (innermost first), for the log; the
// map's dims are the ones CK_MAP gave the launch
struct BoxTag {
  int site;
  bool on;
  short op;
  int e0, e1, e2;
  int flags;
};
// a bulk copy's or cp.async's operand and the operand's base (the region
// is logged in bytes)
struct CopyTag {
  int site;
  bool on;
  short op;
  const void* base;
  int flags;
};
#define CK_BOX(on, op, e0, e1, e2, flags)                                  \
  (::ck::BoxTag{__LINE__, static_cast<bool>(on), static_cast<short>(op), \
                (e0), (e1), (e2), (flags)})
#define CK_COPY(on, op, base, flags)                                        \
  (::ck::CopyTag{__LINE__, static_cast<bool>(on), static_cast<short>(op), \
                 (base), (flags)})
#else
struct BoxTag {};
struct CopyTag {};
#define CK_BOX(on, op, e0, e1, e2, flags) (::ck::BoxTag{})
#define CK_COPY(on, op, base, flags) (::ck::CopyTag{})
#endif
}  // namespace ck

namespace {

#ifdef REPRO_CHECKED
__device__ __forceinline__ void ck_box(const ck::BoxTag& g, int c0, int c1,
                                       int c2) {
  if (g.on)
    ck::box(g.site, g.op, c0, c1, c2, g.e0, g.e1, g.e2, ck::map_dim(g.op, 0),
            ck::map_dim(g.op, 1), ck::map_dim(g.op, 2), g.flags);
}
__device__ __forceinline__ void ck_copy(const ck::CopyTag& g, const void* src,
                                        int bytes) {
  if (g.on) {
    const unsigned char* b = static_cast<const unsigned char*>(g.base);
    const unsigned char* p = static_cast<const unsigned char*>(src);
    ck::region(g.site, ck::kGRead, g.op, b, p, 1, bytes, 0, 1, g.flags);
  }
}
#endif

// ---- mbarriers and TMA -----------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}
// The producer's arrive that announces a slot's bytes: the slot's issue.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes,
                                               ck::Tag tag = {}) {
#ifdef REPRO_CHECKED
  if (tag.on) ck::issue(tag.site, tag.ring, tag.slot, tag.who, tag.to);
#endif
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
// An arrive; tagged, a consumer's release of a slot (logged before the
// arrive publishes it).
__device__ __forceinline__ void mbar_arrive(uint32_t bar, ck::Tag tag = {}) {
#ifdef REPRO_CHECKED
  if (tag.on) ck::release(tag.site, tag.ring, tag.slot, tag.who);
#endif
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
// Waits for the phase of parity `parity` to complete; traps after 2^34
// cycles (~9 s: a fault in the pipeline, never a slow load).  Tagged, the
// wait of a slot's fill (logged after it returns).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity,
                                          ck::Tag tag = {}) {
  const long long t0 = clock64();
  while (true) {
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
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
#ifdef REPRO_CHECKED
  if (tag.on)
    ck::wait(tag.site, tag.ring, tag.slot, static_cast<int>(parity), tag.who);
#endif
}
// One box of a 3-D tensor map into shared memory at dst, its bytes
// counted on the mbarrier bar; the second form with an L2 cache policy
// from createpolicy.
__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1, int c2,
                                       ck::BoxTag tag = {}) {
#ifdef REPRO_CHECKED
  ck_box(tag, c0, c1, c2);
#endif
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1, int c2,
                                       uint64_t policy, ck::BoxTag tag = {}) {
#ifdef REPRO_CHECKED
  ck_box(tag, c0, c1, c2);
#endif
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%3, %4, %5}], [%2], %6;" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "l"(policy)
      : "memory");
}
// One box of a 2-D tensor map, as tma_3d; the second form with an L2
// cache policy.
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1,
                                       ck::BoxTag tag = {}) {
#ifdef REPRO_CHECKED
  ck_box(tag, c0, c1, 0);
#endif
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1,
                                       uint64_t policy, ck::BoxTag tag = {}) {
#ifdef REPRO_CHECKED
  ck_box(tag, c0, c1, 0);
#endif
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%3, %4}], [%2], %5;" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "l"(policy)
      : "memory");
}
// `bytes` contiguous bytes from global to shared memory, completing on
// mbarrier `bar` (both addresses and the size multiples of 16).
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar,
                                          ck::CopyTag tag = {}) {
#ifdef REPRO_CHECKED
  ck_copy(tag, src, static_cast<int>(bytes));
#endif
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// ---- cp.async --------------------------------------------------------------

// 16 bytes global -> shared (cached in L2 only); the second form reads
// src_bytes of them and writes zeros for the rest (0: reads nothing).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           ck::CopyTag tag = {}) {
#ifdef REPRO_CHECKED
  ck_copy(tag, gmem, 16);
#endif
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes,
                                           ck::CopyTag tag = {}) {
#ifdef REPRO_CHECKED
  ck_copy(tag, gmem, src_bytes);
#endif
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
// 4 bytes global -> shared (cached in L1 too)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          ck::CopyTag tag = {}) {
#ifdef REPRO_CHECKED
  ck_copy(tag, gmem, 4);
#endif
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
// Ends this thread's group of copies; tagged, one commit of a cp.async
// group ring (the kernels keep the commits uniform across the block).
__device__ __forceinline__ void cp_async_commit(ck::Tag tag = {}) {
#ifdef REPRO_CHECKED
  if (tag.on) ck::commit(tag.site, tag.ring);
#endif
  asm volatile("cp.async.commit_group;\n" ::);
}
// Waits until at most N of this thread's groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- wgmma -----------------------------------------------------------------

// wgmma shared-memory descriptor under the 128-byte swizzle: start address,
// leading and stride byte offsets (all >> 4), layout type 1 (bits 62-63).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_operand(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
// a warpgroup's registers a thread, raised or lowered (the warpgroups of a
// block with a producer hand its registers to the consumers)
template <int N>
__device__ __forceinline__ void regs_up() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_down() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// a pair of bf16 values as the 32-bit register operand of an instruction
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- host: tensor maps -----------------------------------------------------

// cuTensorMapEncodeTiled looked up through the CUDA runtime, so the
// library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult qr;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr,
                                         12000, cudaEnableDefault,
                                         &qr) != cudaSuccess ||
        qr != cudaDriverEntryPointSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &qr) != cudaSuccess ||
        qr != cudaDriverEntryPointSuccess)
      return nullptr;
#endif
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

}  // namespace
