// flow_update: the tracker's 16-lane ALU fold of packet meta registers into
// the flow-history table.
//
// Replaces src/repro/kernels/flow_features/flow_features.py:flow_update (body
// _flow_kernel), which walks all P packets in order over a VMEM-resident table.
//
// Bound: launch overhead and latency, not bytes or operations.  The work is
// P x 16 int ops; the bytes are the touched rows plus P meta words per lane,
// and the 8k x 16 table copy the wrapper makes.  Every packet of one slot
// depends on the one before, so the serial chain is the longest segment.
//
// Design: Hopper has no ordered grid, so the order lives in the data.  The
// wrapper hands over the packets' slots sorted (stable) and the permutation
// into meta.  One group of 16 threads starts at every packet position; only
// the group at a segment head works, walking that segment's packets in order
// with lane j of the row in thread j's register.  A packet's lane j reads the
// OLD lane hist_src[j] through a 16-wide shuffle, so a program that reads
// another lane sees the pre-packet row.  The row is stored once, at the end.
// Slots outside [0, F) (padding, keep=False) are skipped.  add/sub/inc wrap in
// uint32: JAX's int32 wraps, and signed overflow is undefined in C++.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 16;
constexpr int kGroupsPerBlock = 8;  // 128 threads

// Micro-ops {0 nop, 1 wr, 2 add, 3 sub, 4 max, 5 min, 6 inc}; an undefined
// opcode keeps the history lane, as jnp.select's default does.
__device__ __forceinline__ int32_t alu(int op, int32_t a, int32_t b) {
  const uint32_t ua = static_cast<uint32_t>(a);
  const uint32_t ub = static_cast<uint32_t>(b);
  switch (op) {
    case 1: return a;
    case 2: return static_cast<int32_t>(ub + ua);
    case 3: return static_cast<int32_t>(ub - ua);
    case 4: return max(b, a);
    case 5: return min(b, a);
    case 6: return static_cast<int32_t>(ub + 1u);
    default: return b;
  }
}

__global__ void __launch_bounds__(kLanes * kGroupsPerBlock)
flow_update_kernel(const int32_t* __restrict__ program,  // (16, 3)
                   const int32_t* __restrict__ slots,    // (P,) sorted
                   const int64_t* __restrict__ order,    // (P,) row of meta
                   const int32_t* __restrict__ meta,     // (P, meta_width)
                   int32_t* __restrict__ table,          // (F, 16), in place
                   int p, int f, int meta_width) {
  const int lane = threadIdx.x % kLanes;
  const int head = blockIdx.x * kGroupsPerBlock + threadIdx.x / kLanes;
  // every condition below is uniform across the 16 threads of a group
  if (head >= p) return;
  const int slot = slots[head];
  if (slot < 0 || slot >= f) return;
  if (head > 0 && slots[head - 1] == slot) return;  // not a segment head

  const unsigned mask = 0xFFFFu << (threadIdx.x & 16);  // this half-warp
  const int op = program[lane * 3 + 0];
  const int msrc = program[lane * 3 + 1];
  const int hsrc = program[lane * 3 + 2];
  int32_t h = table[static_cast<size_t>(slot) * kLanes + lane];
  for (int i = head; i < p && slots[i] == slot; ++i) {
    const int32_t a = meta[order[i] * meta_width + msrc];
    const int32_t b = __shfl_sync(mask, h, hsrc, kLanes);
    h = alu(op, a, b);
  }
  table[static_cast<size_t>(slot) * kLanes + lane] = h;
}

}  // namespace

extern "C" int flow_update_launch(const void* program, const void* slots,
                                  const void* order, const void* meta,
                                  void* table, int p, int f, int meta_width,
                                  void* stream) {
  const int blocks = (p + kGroupsPerBlock - 1) / kGroupsPerBlock;
  flow_update_kernel<<<blocks, kLanes * kGroupsPerBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(program), static_cast<const int32_t*>(slots),
      static_cast<const int64_t*>(order), static_cast<const int32_t*>(meta),
      static_cast<int32_t*>(table), p, f, meta_width);
  return static_cast<int>(cudaGetLastError());
}
