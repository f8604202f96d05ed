// The checked build's event log: what the kernels of this directory do to
// their rings, their global operands and their counters, recorded on the
// card for the rules of src/repro_torch/analysis (index-range,
// parallel-race, ring-slot-war, sem-balance, the order rules and
// vmem-budget).  Everything here compiles to nothing unless REPRO_CHECKED is
// defined (kernels/build.py's checked variant: -DREPRO_CHECKED -lineinfo):
// the release build's code is the same with or without this header.
//
// Device side.  One log of fixed-size records in global memory, shared by
// every checked library of a process (kernels/build.py points each at it
// with repro_check_set_log).  A record takes its place with one atomicAdd
// on the log's write index, so its index orders it after every record that
// happens before it: log a release before the mbarrier.arrive that
// publishes it, and an issue or a read after the wait that permits it.  A
// full log sets its overflow flag, which the decoder reports as a finding.
//
// Call sites.  CK(fn, args...) calls ck::fn(__LINE__, args...) in the
// checked build and is nothing in the release build; CK_IF(cond, fn, ...)
// does so where cond holds; CK_BEGIN() logs the launch's grid and shared
// memory (CTA 0).  The ring primitives of hopper.cuh take a
// trailing ck::Tag (CK_TAG(on, ring, slot, who)), which is an empty struct
// in the release build.  Events of a ring are logged by one thread of each
// agent (`on`): the elected producer thread, thread 0 of a consumer
// warpgroup, or thread 0 of a block whose threads issue cp.async copies in
// uniform groups.
//
// Host side.  CK_LAUNCH(name, stream) before each kernel launch numbers
// the launch, hands its number to the device on the launch's stream and
// remembers its name; CK_MAP(op, dims..., stream) hands it the dims of a
// tensor map it reads op through; repro_check_launches hands the names to
// the host (src/repro_torch/analysis/trace.py decodes both).
// CK_NAMES(text) names a library's operands and rings ("op:<id>:<name>
// ring:<id>:<name>").
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace ck {

#ifdef REPRO_CHECKED

// ---- the log ---------------------------------------------------------------

enum Kind : unsigned char {
  kBegin = 1,      // CTA 0: grid, block, dynamic and total shared memory
  kOperand = 2,    // CTA 0: an operand's base address, role, element size
  kRing = 3,       // CTA 0: a ring's depth and kind
  kIssue = 4,      // a ring slot's fill started (aux: its mbarrier slot)
  kWait = 5,       // a fill waited on (mbarrier: aux = parity; cp.async
                   // groups: slot -1, aux = groups left pending)
  kRead = 6,       // shared memory of a slot read
  kRelease = 7,    // a slot handed back for refill
  kCommit = 8,     // a cp.async group committed (empty ones too)
  kGRead = 9,      // a global region read
  kGWrite = 10,    // a global region written
  kGAtomic = 11,   // a global region accumulated atomically
  kBox = 12,       // a TMA box read: coords, box and the map's dims
  kCounter = 13,   // a counter incremented: index, value seen, expected
  kPass = 14,      // the agent starts pass aux
};
enum Role : int { kInput = 0, kOutput = 1, kWorkspace = 2, kCounterOp = 3 };
enum RingKind : int { kMbarrier = 0, kGroups = 1 };
enum Flag : unsigned char { kZeroFill = 1 };

struct Record {            // 96 bytes; trace.py's RECORD_DTYPE
  unsigned seq;            // 1 + the record's index: 0 = never written
  unsigned launch;
  unsigned cta;            // linear block index
  unsigned short site;     // source line
  unsigned char kind;
  unsigned char flags;
  short obj;               // operand or ring
  short slot;
  short who;               // the agent of a ring event
  short esize;             // element bytes of a region
  int aux;
  int pad;
  long long a;             // region start (elements) / address / index
  long long b;             // region row stride / value seen / total smem
  int v[12];               // rows, cols, col stride / box / grid
};
static_assert(sizeof(Record) == 96, "record layout");

struct Log {
  unsigned next;           // write index
  unsigned overflow;       // set when a record found the log full
  unsigned capacity;       // records
  unsigned pad;
  Record rec[1];
};

}  // namespace ck

namespace {
__device__ ck::Log* g_ck_log = nullptr;
__device__ unsigned g_ck_launch = 0;
// the dims (innermost first) of each operand a launch reads through a
// tensor map, from CK_MAP
__device__ long long g_ck_map[16][3];
}  // namespace

namespace ck {

__device__ __forceinline__ long long map_dim(int op, int i) {
  return g_ck_map[op & 15][i];
}
__device__ __forceinline__ unsigned cta_id() {
  return blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
}
__device__ __forceinline__ bool first_thread() {
  return threadIdx.x == 0 && threadIdx.y == 0 && threadIdx.z == 0 &&
         cta_id() == 0;
}

__device__ __noinline__ Record* put(int site, int kind) {
  Log* log = g_ck_log;
  if (log == nullptr) return nullptr;
  const unsigned i = atomicAdd(&log->next, 1u);
  if (i >= log->capacity) {
    atomicExch(&log->overflow, 1u);
    return nullptr;
  }
  Record* r = &log->rec[i];
  r->launch = g_ck_launch;
  r->cta = cta_id();
  r->site = static_cast<unsigned short>(site);
  r->kind = static_cast<unsigned char>(kind);
  r->flags = 0;
  r->obj = r->slot = r->who = r->esize = 0;
  r->aux = r->pad = 0;
  r->a = r->b = 0;
#pragma unroll
  for (int j = 0; j < 12; ++j) r->v[j] = 0;
  r->seq = i + 1;
  return r;
}

// ---- declarations (CTA 0, thread 0) ---------------------------------------

// grid, block and shared memory of this launch, read from the card
__device__ __forceinline__ void begin(int site) {
  if (!first_thread()) return;
  unsigned dyn, total;
  asm volatile("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn));
  asm volatile("mov.u32 %0, %%total_smem_size;" : "=r"(total));
  if (Record* r = put(site, kBegin)) {
    r->v[0] = gridDim.x;
    r->v[1] = gridDim.y;
    r->v[2] = gridDim.z;
    r->v[3] = blockDim.x * blockDim.y * blockDim.z;
    r->a = dyn;
    r->b = total;
  }
}
template <typename T>
__device__ __forceinline__ void operand(int site, int op, const T* base,
                                        int role) {
  if (!first_thread()) return;
  if (Record* r = put(site, kOperand)) {
    r->obj = static_cast<short>(op);
    r->aux = role;
    r->esize = static_cast<short>(sizeof(T));
    r->a = static_cast<long long>(reinterpret_cast<uintptr_t>(base));
  }
}
__device__ __forceinline__ void ring(int site, int id, int depth, int kind) {
  if (!first_thread()) return;
  if (Record* r = put(site, kRing)) {
    r->obj = static_cast<short>(id);
    r->aux = depth;
    r->v[0] = kind;
  }
}

// ---- ring events -----------------------------------------------------------

// v[0]: the mbarrier slot; v[1]: 1 + an issue's one reader (0: every
// reader of the ring waits on the fill)
__device__ __forceinline__ void ring_event(int site, int kind, int ring,
                                           int slot, int who, int aux,
                                           int bar, int to = -1) {
  if (Record* r = put(site, kind)) {
    r->obj = static_cast<short>(ring);
    r->slot = static_cast<short>(slot);
    r->who = static_cast<short>(who);
    r->aux = aux;
    r->v[0] = bar;
    r->v[1] = to + 1;
  }
}
__device__ __forceinline__ void issue(int site, int ring, int slot,
                                      int who = 0, int to = -1) {
  ring_event(site, kIssue, ring, slot, who, 0, slot, to);
}
__device__ __forceinline__ void wait(int site, int ring, int slot,
                                     int parity, int who = 0) {
  ring_event(site, kWait, ring, slot, who, parity, slot);
}
__device__ __forceinline__ void read(int site, int ring, int slot,
                                     int who = 0) {
  ring_event(site, kRead, ring, slot, who, 0, slot);
}
__device__ __forceinline__ void release(int site, int ring, int slot,
                                        int who = 0) {
  ring_event(site, kRelease, ring, slot, who, 0, slot);
}
// cp.async groups: a commit, and a wait_group<pending> whose barrier has
// made every thread's completed copies visible
__device__ __forceinline__ void commit(int site, int ring) {
  ring_event(site, kCommit, ring, -1, 0, 0, -1);
}
__device__ __forceinline__ void groups(int site, int ring, int pending) {
  ring_event(site, kWait, ring, -1, 0, pending, -1);
}
__device__ __forceinline__ void pass(int site, int index, int who = 0) {
  if (Record* r = put(site, kPass)) {
    r->who = static_cast<short>(who);
    r->aux = index;
  }
}

// ---- global memory ---------------------------------------------------------

// rows x cols elements of operand op from p on: row r, column j at
// p + r * row_stride + j * col_stride (strides in elements)
template <typename T>
__device__ __forceinline__ void region(int site, int kind, int op,
                                       const T* base, const T* p, int rows,
                                       int cols, long long row_stride,
                                       int col_stride, int flags) {
  if (Record* r = put(site, kind)) {
    r->obj = static_cast<short>(op);
    r->esize = static_cast<short>(sizeof(T));
    r->flags = static_cast<unsigned char>(flags);
    r->a = static_cast<long long>(p - base);
    r->b = row_stride;
    r->v[0] = rows;
    r->v[1] = cols;
    r->v[2] = col_stride;
  }
}
template <typename T>
__device__ __forceinline__ void gread(int site, int op, const T* base,
                                      const T* p, int rows, int cols,
                                      long long row_stride = 0,
                                      int col_stride = 1, int flags = 0) {
  region(site, kGRead, op, base, p, rows, cols, row_stride, col_stride,
         flags);
}
template <typename T>
__device__ __forceinline__ void gwrite(int site, int op, const T* base,
                                       const T* p, int rows, int cols,
                                       long long row_stride = 0,
                                       int col_stride = 1) {
  region(site, kGWrite, op, base, p, rows, cols, row_stride, col_stride, 0);
}
template <typename T>
__device__ __forceinline__ void gatomic(int site, int op, const T* base,
                                        const T* p, int rows, int cols,
                                        long long row_stride = 0) {
  region(site, kGAtomic, op, base, p, rows, cols, row_stride, 1, 0);
}
// the same operand declaration or read for several operands, numbered
// from `op` on: items [lo, lo + n) of each schedule array, say
template <typename T>
__device__ __forceinline__ void operand_each(int site, int op, int role,
                                             const T* p) {
  operand(site, op, p, role);
}
template <typename T, typename... R>
__device__ __forceinline__ void operand_each(int site, int op, int role,
                                             const T* p, const R*... rest) {
  operand(site, op, p, role);
  operand_each(site, op + 1, role, rest...);
}
template <typename T>
__device__ __forceinline__ void gread_each(int site, int op, long long lo,
                                           int n, const T* p) {
  gread(site, op, p, p + lo, 1, n);
}
template <typename T, typename... R>
__device__ __forceinline__ void gread_each(int site, int op, long long lo,
                                           int n, const T* p,
                                           const R*... rest) {
  gread(site, op, p, p + lo, 1, n);
  gread_each(site, op + 1, lo, n, rest...);
}
// rows first .. first + n - 1 (those below len) of plane `plane` of a
// (planes, len, D) operand of 2- or 4-byte elements, as one region of
// bytes
__device__ __forceinline__ void rows(int site, int kind, int op,
                                     const void* base, int is_bf16,
                                     long long plane, int first, int n,
                                     int len, int D) {
  const int es = is_bf16 ? 2 : 4;
  const int m = n < len - first ? n : len - first;
  if (m <= 0) return;
  const unsigned char* b = static_cast<const unsigned char*>(base);
  region(site, kind, op, b, b + (plane * len + first) * D * es, 1, m * D * es,
         0, 1, 0);
}
// a TMA box: coordinates c, box extents e and the map's dims d, innermost
// first (a 2-D map passes 1 for the third)
__device__ __forceinline__ void box(int site, int op, int c0, int c1, int c2,
                                    int e0, int e1, int e2, long long d0,
                                    long long d1, long long d2,
                                    int flags = 0) {
  if (Record* r = put(site, kBox)) {
    r->obj = static_cast<short>(op);
    r->flags = static_cast<unsigned char>(flags);
    r->v[0] = c0;
    r->v[1] = c1;
    r->v[2] = c2;
    r->v[3] = e0;
    r->v[4] = e1;
    r->v[5] = e2;
    r->v[6] = static_cast<int>(d0);
    r->v[7] = static_cast<int>(d1);
    r->v[8] = static_cast<int>(d2);
  }
}
// a counter increment: its index, the value the atomic returned and the
// number of increments the kernel expects (0: not known)
__device__ __forceinline__ void counter(int site, int op, long long index,
                                        int seen, int expected = 0) {
  if (Record* r = put(site, kCounter)) {
    r->obj = static_cast<short>(op);
    r->a = index;
    r->b = seen;
    r->aux = expected;
  }
}

// ---- tags of the ring primitives --------------------------------------------

struct Tag {
  int site;
  bool on;      // this thread logs the event
  short ring;
  short slot;
  short who;
  short to;     // an issue's one reader (-1: all)
};

#else  // the release build: empty tags, no events

struct Tag {};

#endif  // REPRO_CHECKED

}  // namespace ck

#ifdef REPRO_CHECKED

#define CK(fn, ...) ::ck::fn(__LINE__, __VA_ARGS__)
#define CK_IF(cond, fn, ...)                   \
  do {                                         \
    if (cond) ::ck::fn(__LINE__, __VA_ARGS__); \
  } while (0)
#define CK_BEGIN() ::ck::begin(__LINE__)
#define CK_TAG(on, ring, slot, who)                                     \
  (::ck::Tag{__LINE__, static_cast<bool>(on), static_cast<short>(ring), \
             static_cast<short>(slot), static_cast<short>(who), -1})
// the issue of a fill that one reader (`to`) consumes
#define CK_TAG_FOR(on, ring, slot, who, to)                             \
  (::ck::Tag{__LINE__, static_cast<bool>(on), static_cast<short>(ring), \
             static_cast<short>(slot), static_cast<short>(who),         \
             static_cast<short>(to)})

// ---- host: the launch table ------------------------------------------------

namespace ck {
struct HostLaunch {        // trace.py's LAUNCH_DTYPE
  char name[56];
  unsigned id;
  unsigned pad;
};
constexpr int kMaxLaunches = 256;
inline HostLaunch g_launches[kMaxLaunches];
inline int g_n_launches = 0;
inline unsigned g_launch_base = 0;

inline int host_launch(const char* name, cudaStream_t stream) {
  const unsigned id = g_launch_base + static_cast<unsigned>(g_n_launches);
  if (g_n_launches < kMaxLaunches) {
    HostLaunch& l = g_launches[g_n_launches];
    int i = 0;
    for (; name[i] && i < 55; ++i) l.name[i] = name[i];
    l.name[i] = 0;
    l.id = id;
  }
  ++g_n_launches;
  return static_cast<int>(cudaMemcpyToSymbolAsync(
      g_ck_launch, &id, sizeof(id), 0, cudaMemcpyHostToDevice, stream));
}
}  // namespace ck

// The log every kernel of this library writes to (nullptr: none).
extern "C" int repro_check_set_log(void* log) {
  return static_cast<int>(
      cudaMemcpyToSymbol(g_ck_log, &log, sizeof(log)));
}
// Forget the launches so far; the next is numbered `base`.
extern "C" void repro_check_reset(unsigned base) {
  ck::g_n_launches = 0;
  ck::g_launch_base = base;
}
// Copies at most `max` launches to `out`; returns how many there were.
extern "C" int repro_check_launches(ck::HostLaunch* out, int max) {
  const int n = ck::g_n_launches < ck::kMaxLaunches ? ck::g_n_launches
                                                    : ck::kMaxLaunches;
  for (int i = 0; i < n && i < max; ++i) out[i] = ck::g_launches[i];
  return ck::g_n_launches;
}

namespace ck {
inline int host_map(int op, long long d0, long long d1, long long d2,
                    cudaStream_t stream) {
  const long long d[3] = {d0, d1, d2};
  return static_cast<int>(cudaMemcpyToSymbolAsync(
      g_ck_map, d, sizeof(d), sizeof(d) * (op & 15), cudaMemcpyHostToDevice,
      stream));
}
}  // namespace ck

// the dims of the tensor map through which the next launch reads op
#define CK_MAP(op, d0, d1, d2, stream)                            \
  do {                                                            \
    const int ck_err = ::ck::host_map(op, d0, d1, d2, stream);    \
    if (ck_err != 0) return ck_err;                               \
  } while (0)
#define CK_LAUNCH(name, stream)                          \
  do {                                                   \
    const int ck_err = ::ck::host_launch(name, stream);  \
    if (ck_err != 0) return ck_err;                      \
  } while (0)
#define CK_NAMES(text) \
  extern "C" const char* repro_check_names() { return text; }

#else

#define CK(fn, ...) ((void)0)
#define CK_IF(cond, fn, ...) ((void)0)
#define CK_BEGIN() ((void)0)
#define CK_TAG(on, ring, slot, who) (::ck::Tag{})
#define CK_TAG_FOR(on, ring, slot, who, to) (::ck::Tag{})
#define CK_LAUNCH(name, stream) ((void)0)
#define CK_MAP(op, d0, d1, d2, stream) ((void)0)
#define CK_NAMES(text)

#endif  // REPRO_CHECKED
