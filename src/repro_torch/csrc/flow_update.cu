// flow_update: the tracker's 16-lane ALU fold of packet meta registers into a
// copy of the flow-history table, in one launch that orders the packets itself.
//
// Replaces src/repro/kernels/flow_features/flow_features.py:flow_update (body
// _flow_kernel), which walks all P packets in order over a VMEM-resident table.
//
// Bound: the launch and a few dependent memory round trips.  The work is
// P x 16 int ops; the bytes are the table read and written once, the slots
// and the meta.  Every packet of one slot depends on the one before, so the
// serial chain is the longest segment.
//
// Design: Hopper has no ordered grid, so each CTA orders what it needs in
// shared memory, and no CTA waits for another.  kernels/flow_features/ops.py:
// flow_plan gives the grid and the chunk.
// - CTA c owns the rows [c * rows, (c + 1) * rows) and is their only writer:
//   it copies them from the input table (16-byte stores where both tables are
//   16-byte aligned), then folds the packets of its rows over the copy.
// - It walks the batch in chunks of at most `cap` packets: one chunk in the
//   "single" variant (P <= cap), several in the "chunked" one.  Every thread
//   reads a share of the chunk's slots and appends each packet of an owned
//   row as the 32-bit key (row - c * rows) << log2(cap) | (i - chunk start),
//   through one shared atomic a warp.  The key carries
//   the packet's index, so the order of the appends does not matter.
// - A sort of the n keys orders them by row, then by batch index: up to one
//   key a thread, each key's rank among them (two barriers); past that, a
//   bitonic network (padded to a power of two with 0xFFFFFFFF, which no key
//   reaches: the plan bounds rows).  The keys are unique, so either is
//   stable.
// - Segment heads are where the row changes.  A group of 16 threads takes
//   each head and walks its segment with lane j of the row in thread j's
//   register, reading the meta of kAhead packets at a time ahead of their
//   folds, so a step's chain is three ALU ops (see Step).  A packet's lane j
//   reads the OLD lane hist_src[j] through a 16-wide shuffle, so a program
//   that reads another lane sees the pre-packet row (no shuffle where every
//   lane reads its own, as the default program does).
//   The row is stored once a segment.  The first chunk reads the rows from the
//   input table; a later chunk reads the output, which barriers of this CTA
//   order after the copy and the last chunk's folds.
// Slots outside [0, F) (padding, keep=False) are owned by no CTA and dropped.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 16;
constexpr int kThreads = 256;
constexpr int kGroups = kThreads / kLanes;
constexpr int kSlotsAhead = 4;  // slots a thread reads before appending them
constexpr int kAhead = 16;      // meta reads in flight a fold group
constexpr int kMaxCap = 8192;   // keys a CTA sorts: 32 KB of shared memory
constexpr uint32_t kPad = 0xFFFFFFFFu;

// Micro-ops {0 nop, 1 wr, 2 add, 3 sub, 4 max, 5 min, 6 inc}; an undefined
// opcode keeps the history lane, as jnp.select's default does.  Every op is
// min(max(b + d, lo), hi) with (d, lo, hi) from the op and the meta value a
// alone, so a fold step's chain through the old lane b is three ALU ops:
//   nop/other (0, MIN, MAX)  wr (0, a, a)  add (a, MIN, MAX)  sub (-a, MIN, MAX)
//   max (0, a, MAX)  min (0, MIN, a)  inc (1, MIN, MAX)
// b + d wraps in uint32 (JAX's int32 wraps; signed overflow is undefined in C++).
struct Step {
  uint32_t d;
  int32_t lo, hi;
};

__device__ __forceinline__ Step step_of(int op, int32_t a) {
  const uint32_t ua = static_cast<uint32_t>(a);
  Step s{0u, INT32_MIN, INT32_MAX};
  if (op == 1) s.lo = s.hi = a;
  if (op == 2) s.d = ua;
  if (op == 3) s.d = 0u - ua;
  if (op == 4) s.lo = a;
  if (op == 5) s.hi = a;
  if (op == 6) s.d = 1u;
  return s;
}

__device__ __forceinline__ int32_t apply(const Step& s, int32_t b) {
  return min(max(static_cast<int32_t>(static_cast<uint32_t>(b) + s.d), s.lo), s.hi);
}

// Ascending bitonic sort of keys[0, n2), n2 a power of two.
__device__ __forceinline__ void bitonic_sort(uint32_t* keys, int n2) {
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < n2 / 2; t += kThreads) {
        const int lo = 2 * t - (t & (j - 1));
        const uint32_t a = keys[lo], b = keys[lo + j];
        if ((a > b) == ((lo & k) == 0)) {
          keys[lo] = b;
          keys[lo + j] = a;
        }
      }
      __syncthreads();
    }
  }
}

template <bool kChunked>
__global__ void __launch_bounds__(kThreads)
flow_update_kernel(const int32_t* __restrict__ program,  // (16, 3)
                   const int32_t* __restrict__ slots,    // (P,) any order
                   const int32_t* __restrict__ meta,     // (P, meta_width)
                   const int32_t* __restrict__ table,    // (F, 16) in
                   int32_t* __restrict__ out,            // (F, 16) out
                   int p, int f, int meta_width, int rows, int cap) {
  extern __shared__ uint32_t keys[];
  __shared__ int count;
  const int tid = threadIdx.x;
  const int f0 = min(f, static_cast<int>(blockIdx.x) * rows);
  const int nrows = min(f, f0 + rows) - f0;
  const int ib = __ffs(cap) - 1;  // index bits of a key
  const uint32_t imask = static_cast<uint32_t>(cap) - 1u;

  if (tid == 0) count = 0;
  __syncthreads();
  // the copy: its first share stays in a register across the first chunk's
  // slot reads, so their round trips and the program's overlap
  const bool vec = ((reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int ncopy = nrows * (vec ? kLanes / 4 : kLanes);
  const size_t copy0 = static_cast<size_t>(f0) * (vec ? kLanes / 4 : kLanes);
  int4 first4;
  int32_t first1 = 0;
  if (tid < ncopy) {
    if (vec) first4 = reinterpret_cast<const int4*>(table)[copy0 + tid];
    else first1 = table[copy0 + tid];
  }
  const int lane = tid % kLanes;
  const int op = program[lane * 3 + 0];
  const int msrc = program[lane * 3 + 1];
  const int hsrc = program[lane * 3 + 2];
  const unsigned half = 0xFFFFu << (tid & 16);

  for (int base = 0;; base += cap) {
    const int chunk = min(cap, p - base);
    // append the owned packets of this chunk
    for (int i0 = 0; i0 < chunk; i0 += kSlotsAhead * kThreads) {
      int s[kSlotsAhead];
#pragma unroll
      for (int u = 0; u < kSlotsAhead; ++u) {
        const int i = i0 + u * kThreads + tid;
        s[u] = i < chunk ? slots[base + i] : -1;
      }
#pragma unroll
      for (int u = 0; u < kSlotsAhead; ++u) {
        const int i = i0 + u * kThreads + tid;
        // a slot below f0, negative ones included, wraps past nrows
        const uint32_t row = static_cast<uint32_t>(s[u]) - static_cast<uint32_t>(f0);
        const bool own = row < static_cast<uint32_t>(nrows);
        const unsigned ballot = __ballot_sync(0xFFFFFFFFu, own);
        if (ballot == 0) continue;
        const int leader = __ffs(ballot) - 1;
        int at = 0;
        if ((tid & 31) == leader) at = atomicAdd(&count, __popc(ballot));
        at = __shfl_sync(0xFFFFFFFFu, at, leader);
        if (own) {
          keys[at + __popc(ballot & ((1u << (tid & 31)) - 1u))] =
              (row << ib) | static_cast<uint32_t>(i);
        }
      }
    }
    if (base == 0 && tid < ncopy) {
      if (vec) reinterpret_cast<int4*>(out)[copy0 + tid] = first4;
      else out[copy0 + tid] = first1;
    }
    if (base == 0) {
      for (int i = tid + kThreads; i < ncopy; i += kThreads) {
        if (vec) {
          reinterpret_cast<int4*>(out)[copy0 + i] = reinterpret_cast<const int4*>(table)[copy0 + i];
        } else {
          out[copy0 + i] = table[copy0 + i];
        }
      }
    }
    __syncthreads();
    const int n = count;
    if (n <= kThreads) {
      // rank sort: thread i's key goes to the count of smaller keys, two
      // barriers in all (the bitonic network alone, a barrier a stage,
      // measured about 1.1 us slower at spread slots; PERF.md §6)
      uint32_t mine = 0;
      int rank = 0;
      if (tid < n) {
        mine = keys[tid];
        for (int j = 0; j < n; ++j) rank += keys[j] < mine;
      }
      __syncthreads();  // every thread has read count and the keys
      if (tid == 0) count = 0;  // the next chunk's, appended to after a later barrier
      if (tid < n) keys[rank] = mine;
      __syncthreads();
    } else {
      int n2 = 1;
      while (n2 < n) n2 <<= 1;
      for (int i = n + tid; i < n2; i += kThreads) keys[i] = kPad;
      __syncthreads();  // every thread has read count
      if (tid == 0) count = 0;
      bitonic_sort(keys, n2);
    }

    // fold: one group of 16 threads a segment, with no shuffle where every
    // lane reads its own (the default program); tested here, after the slot
    // reads, so the program's round trip hides behind theirs
    const bool own_lane = __all_sync(0xFFFFFFFFu, hsrc == lane);
    for (int s = tid / kLanes; s < n; s += kGroups) {
      const uint32_t row = keys[s] >> ib;
      if (s > 0 && (keys[s - 1] >> ib) == row) continue;  // not a segment head
      const size_t at = static_cast<size_t>(f0 + static_cast<int>(row)) * kLanes + lane;
      // a later chunk reads the row as this CTA last stored it
      int32_t h = (kChunked && base > 0) ? out[at] : table[at];
      for (int e = s;;) {
        // the next kAhead keys of the segment (they ascend, so it is
        // contiguous); past its end each slot repeats its last key, so all
        // kAhead meta reads are unconditional and in flight together
        uint32_t key[kAhead];
        uint32_t last = keys[min(e, n - 1)];
        int got = 0;
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const uint32_t k = keys[min(e + u, n - 1)];
          if (got == u && e + u < n && (k >> ib) == row) {
            got = u + 1;
            last = k;
          }
          key[u] = last;
        }
        int32_t a[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          a[u] = meta[static_cast<size_t>(base + static_cast<int>(key[u] & imask)) * meta_width +
                      msrc];
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const int32_t b = own_lane ? h : __shfl_sync(half, h, hsrc, kLanes);
          const int32_t next = apply(step_of(op, a[u]), b);
          h = u < got ? next : h;
        }
        e += got;
        if (got < kAhead) break;
      }
      out[at] = h;
    }
    if (!kChunked || p - base <= cap) break;  // the last chunk
    __syncthreads();  // this chunk's folds land before the next one reads them
  }
}

}  // namespace

// ctas, cap and the variant come from flow_plan: cap a power of two up to
// kMaxCap, and every key below the sort's pad ((rows - 1) << log2(cap) |
// (cap - 1) < 0xFFFFFFFF).  A grid that leaves rows unowned, or the single
// variant on more than one chunk, is refused too.
extern "C" int flow_update_launch(const void* program, const void* slots, const void* meta,
                                  const void* table, void* out, int p, int f, int meta_width,
                                  int ctas, int cap, int chunked, void* stream) {
  const int ib = __builtin_ctz(static_cast<unsigned>(cap > 0 ? cap : 1));
  const int64_t rows = ctas > 0 ? (static_cast<int64_t>(f) + ctas - 1) / ctas : 0;
  if (p < 0 || f < 1 || meta_width < 1 || ctas < 1 || cap < 1 || cap > kMaxCap ||
      (cap & (cap - 1)) != 0 || rows >= (int64_t{1} << (32 - ib)) ||
      static_cast<int64_t>(ctas) * rows < f || (!chunked && p > cap)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the single variant is its own instantiation: the chunk test at run time
  // measured 0.3 us slower at P 1024 (PERF.md §6)
  auto kernel = chunked ? flow_update_kernel<true> : flow_update_kernel<false>;
  const size_t smem = static_cast<size_t>(cap) * sizeof(uint32_t);
  kernel<<<ctas, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(program), static_cast<const int32_t*>(slots),
      static_cast<const int32_t*>(meta), static_cast<const int32_t*>(table),
      static_cast<int32_t*>(out), p, f, meta_width, static_cast<int>(rows), cap);
  return static_cast<int>(cudaGetLastError());
}
