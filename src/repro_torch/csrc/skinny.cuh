// The skinny-M matmul (M <= 8): cluster split-K that streams the weights, for
// (M,K) @ (K,N) with x and w each f32 or bf16 bits, the sum and the
// activation in f32, the output f32 or bf16 rounded once.  mm_fused's variant A
// (mm_fused.cu) and vpe_mm's one-to-eight-row path (vpe_mm.cu) both launch it,
// each from the plan of kernels/arype_matmul/ops.py:mm_fused_plan, so the two
// engines give the same bits at every M <= 8.
//
// Bound: bytes.  The K*N weights are read once and M*K + M*N are small, so the
// least time is 4*K*N bytes (2*K*N for bf16 w) over 3.35 TB/s (qwen3-0.6b's
// f32 head, 622 MB: 0.19 ms; starcoder2-15b's bf16 head, 604 MB: 0.18 ms).
//
// Design: the grid is (N/BN column slabs, C K ranks), launched as (1, C, 1)
// clusters, C <= 8 from (K, N) only, so that slabs * C comes near 192 CTAs on
// the 132 SMs.  Each CTA stages its x slice in shared memory and streams its
// slab of K/C weight rows with 16-byte non-coherent loads, eight rows a thread
// a step, each step's loads in flight while the previous step's FMAs run (the
// first while x is staged); every weight byte is read once across the grid.
// The CTA's warps reduce through shared memory in a fixed order, then rank 0
// sums the C ranks' partials through distributed shared memory in rank order,
// applies the activation and stores: the aggregation stays on chip, in one
// launch, and the bits are the same from run to run.  C and the K order do not
// depend on M, so row r of an M = 4 call equals an M = 1 call on that row.  A
// bf16 x is converted to its exact f32 while it is staged, and a bf16 w is
// streamed as 2-byte values (half the bytes: 8-byte loads of four columns,
// with the thread's columns and rows as for f32) widened to their exact f32
// in registers, so every pair of types is the f32 kernel on x.float(),
// w.float(), bit for bit: the same FMAs in the same order.  What the bound leaves out is the
// launch's fixed cost (launch, reduction, cluster syncs), which on the H100 is
// of the order of a decode layer's 1.3-3.8 us of weights (PERF.md).
//
// The kernel has internal linkage: each source that includes this header
// builds its own copy, and no kernel symbol is shared between them.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace octo {
namespace {

constexpr int kSkinnyRows = 8;       // M <= 8: rows of every accumulator
constexpr int kSkinnyThreads = 256;
constexpr int kSkinnyUnroll = 8;     // weight rows a thread a step
constexpr int kSkinnyStage = 1024;   // x rows (of K) staged at a time
constexpr int kMaxCluster = 8;       // the portable cluster size

// Four weights of one row at src as f32: one 16-byte load of f32, one
// 8-byte load of bf16 (each value's bits the top half of its f32)
__device__ __forceinline__ float4 load4(const float* src) {
  return __ldg(reinterpret_cast<const float4*>(src));
}
__device__ __forceinline__ float4 load4(const bf16_bits* src) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(src));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xFFFF0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xFFFF0000u));
}

template <int BN, bool kVec, typename TX, typename TW, typename TO>
__global__ void __launch_bounds__(kSkinnyThreads, 2)
mm_skinny_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                 TO* __restrict__ out, int m, int k, int n, int act, int kc) {
  namespace cg = cooperative_groups;
  constexpr int kQuads = BN / 4;                    // lanes across a weight row
  constexpr int kGroups = kSkinnyThreads / kQuads;  // weight rows a CTA step reads at once
  static_assert(kGroups * kSkinnyRows * BN == kSkinnyStage * kSkinnyRows, "smem reuse");
  // x staged as f32 xs[k][8] (two float4 broadcasts a row), reused after the
  // K loop as the warps' partials red[group][row][BN]
  __shared__ __align__(16) float smem[kSkinnyStage * kSkinnyRows];
  __shared__ __align__(16) float part[kSkinnyRows * BN];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  const int q = tid % kQuads, g = tid / kQuads;
  const int col0 = blockIdx.x * BN;
  const int col = col0 + q * 4;
  const int kbeg = min(k, rank * kc), kend = min(k, kbeg + kc);

  float acc[kSkinnyRows][4];
#pragma unroll
  for (int r = 0; r < kSkinnyRows; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

  // eight weight rows a thread, zero past the rank's K range and past N
  auto load_step = [&](float4 (&wv)[kSkinnyUnroll], int c0, int kb, int rows) {
#pragma unroll
    for (int u = 0; u < kSkinnyUnroll; ++u) {
      const int kr = kb + u * kGroups + g;
      const TW* src = w + static_cast<int64_t>(c0 + kr) * n + col;
      wv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (kr < rows) {
        if (kVec) {
          if (col < n) wv[u] = load4(src);
        } else {
          if (col < n) wv[u].x = to_f32(__ldg(src));
          if (col + 1 < n) wv[u].y = to_f32(__ldg(src + 1));
          if (col + 2 < n) wv[u].z = to_f32(__ldg(src + 2));
          if (col + 3 < n) wv[u].w = to_f32(__ldg(src + 3));
        }
      }
    }
  };

  auto fma_step = [&](const float4 (&wv)[kSkinnyUnroll], int kb, int rows) {
    const float4* xs = reinterpret_cast<const float4*>(smem);
#pragma unroll
    for (int u = 0; u < kSkinnyUnroll; ++u) {
      const int kr = kb + u * kGroups + g;
      if (kr >= rows) continue;
      const float4 xa = xs[kr * 2], xb = xs[kr * 2 + 1];
      const float xr[kSkinnyRows] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
      for (int r = 0; r < kSkinnyRows; ++r) {
        acc[r][0] = fmaf(xr[r], wv[u].x, acc[r][0]);
        acc[r][1] = fmaf(xr[r], wv[u].y, acc[r][1]);
        acc[r][2] = fmaf(xr[r], wv[u].z, acc[r][2]);
        acc[r][3] = fmaf(xr[r], wv[u].w, acc[r][3]);
      }
    }
  };

  constexpr int kStep = kGroups * kSkinnyUnroll;  // weight rows a CTA step reads
  for (int c0 = kbeg; c0 < kend; c0 += kSkinnyStage) {
    const int rows = min(kSkinnyStage, kend - c0);
    // two register buffers in turn: one step's loads fly while the other's
    // FMAs run; the first already while x is staged
    float4 wa[kSkinnyUnroll], wb[kSkinnyUnroll];
    load_step(wa, c0, 0, rows);
    __syncthreads();  // the previous chunk's xs reads are done
    for (int i = tid; i < rows * kSkinnyRows; i += kSkinnyThreads) {
      const int r = i / rows, kr = i % rows;
      smem[kr * kSkinnyRows + r] =
          r < m ? to_f32(x[static_cast<int64_t>(r) * k + c0 + kr]) : 0.f;
    }
    __syncthreads();
    for (int kb = 0; kb < rows; kb += 2 * kStep) {
      if (kb + kStep < rows) load_step(wb, c0, kb + kStep, rows);
      fma_step(wa, kb, rows);
      if (kb + kStep >= rows) break;
      if (kb + 2 * kStep < rows) load_step(wa, c0, kb + 2 * kStep, rows);
      fma_step(wb, kb + kStep, rows);
    }
  }

  // the CTA's row groups, summed in group order
  __syncthreads();  // xs is dead: smem becomes red
  float* red = smem;
#pragma unroll
  for (int r = 0; r < kSkinnyRows; ++r)
    *reinterpret_cast<float4*>(&red[(g * kSkinnyRows + r) * BN + q * 4]) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  for (int e = tid; e < m * BN; e += kSkinnyThreads) {
    float s = red[e];
    for (int gg = 1; gg < kGroups; ++gg) s += red[gg * kSkinnyRows * BN + e];
    part[e] = s;
  }
  // the cluster's K ranks, summed in rank order into rank 0 through DSMEM
  cluster.sync();
  if (rank == 0) {
    for (int e = tid; e < m * BN; e += kSkinnyThreads) {
      const int r = e / BN, c = col0 + e % BN;
      if (c >= n) continue;
      float s = part[e];
      for (int rr = 1; rr < ranks; ++rr) s += cluster.map_shared_rank(part, rr)[e];
      put(out + static_cast<int64_t>(r) * n + c, activate(s, act));
    }
  }
  cluster.sync();  // no rank leaves while rank 0 still reads its partials
}

template <int BN, bool kVec, typename TX, typename TW, typename TO>
cudaError_t launch_skinny(const TX* x, const TW* w, TO* out, int m, int k, int n, int act,
                          int split, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + BN - 1) / BN, split, 1);
  cfg.blockDim = dim3(kSkinnyThreads, 1, 1);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int kc = (k + split - 1) / split;
  return cudaLaunchKernelEx(&cfg, mm_skinny_kernel<BN, kVec, TX, TW, TO>, x, w, out, m, k, n,
                            act, kc);
}

// One launch of slabs of bn columns (64 or 128) over `split` K ranks (1..8);
// a load of four weights at once (16 bytes of f32, 8 of bf16) where N and w's
// base allow it.  The caller has checked 1 <= m <= 8 and split; another bn is
// refused with cudaErrorInvalidValue and launches nothing.
template <typename TX, typename TW, typename TO>
cudaError_t launch_skinny_plan(const TX* x, const TW* w, TO* out, int m, int k, int n,
                               int act, int bn, int split, cudaStream_t s) {
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(w) % (4 * sizeof(TW)) == 0;
  if (bn == 64)
    return vec ? launch_skinny<64, true>(x, w, out, m, k, n, act, split, s)
               : launch_skinny<64, false>(x, w, out, m, k, n, act, split, s);
  if (bn == 128)
    return vec ? launch_skinny<128, true>(x, w, out, m, k, n, act, split, s)
               : launch_skinny<128, false>(x, w, out, m, k, n, act, split, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace octo
