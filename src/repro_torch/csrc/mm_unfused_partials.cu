// mm_unfused_partials: the paper's "wo/ collaborating" ablation of the AryPE
// matmul.  Two kernels, two launches per matmul:
//
//   1. partials: for every K block l of width bk, P[l] = x[:, l*bk:(l+1)*bk]
//      @ w[l*bk:(l+1)*bk, :] in f32, written to a (ceil(K/bk), M, N) tensor in
//      device memory;
//   2. aggregation: out = act(P[0] + P[1] + ...), summed in block order, one
//      element per thread.
//
// Replaces src/repro/kernels/arype_matmul/arype_matmul.py:mm_unfused_partials
// (body _mm_partial_kernel, one (l, i, j) grid cell per partial block) and
// the separate `partials.sum(axis=0)` pass of its wrapper
// arype_matmul_unfused (kernels/arype_matmul/ops.py).
//
// The partials round-trip through device memory on purpose: that round trip
// is what the ablation measures (the paper's VU aggregation stalling the
// array).  So the sum is never fused into the partials kernel and nothing is
// carried across K blocks on chip.
//
// Bound: bytes.  x and w are read once each, the partials written once and
// read once more, the output written once; at the pipeline's shapes a few MB,
// so the launches dominate.  The product itself is the SIMT f32 form of
// mm_fused.cu (no TF32: the reference computes in full f32).
//
// Design: the partials kernel is mm_fused.cu's 64x64 output tile per block of
// 256 threads (4x4 register accumulator, x and w tiles of depth 16 staged in
// shared memory) with the K loop limited to the block's own K range, and one
// grid slice (blockIdx.z) per K block.  Ragged M, N and K edges are masked
// (zero-filled loads, guarded stores), so the wrapper pads nothing.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16, kTM = 4, kTN = 4;
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256
constexpr int kSumThreads = 256;

__global__ void __launch_bounds__(kThreads)
mm_partials_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ partials, int m, int k, int n, int bk) {
  __shared__ float xs[kBK][kBM];  // transposed x tile: xs[depth][row]
  __shared__ float ws[kBK][kBN];
  const int tid = threadIdx.x;
  const int tr = tid / (kBN / kTN);
  const int tc = tid % (kBN / kTN);
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int col0 = blockIdx.x * kBN;
  const int kbeg = blockIdx.z * bk;
  const int kend = min(kbeg + bk, k);

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      const int64_t gr = row0 + r;
      const int gc = k0 + c;
      xs[c][r] = (gr < m && gc < kend) ? x[gr * k + gc] : 0.f;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN, c = i % kBN;
      const int gr = k0 + r, gc = col0 + c;
      ws[r][c] = (gr < kend && gc < n) ? w[static_cast<int64_t>(gr) * n + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = xs[kk][tr * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = ws[kk][tc * kTN + j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = partials + static_cast<int64_t>(blockIdx.z) * m * n;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int64_t r = row0 + tr * kTM + i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = col0 + tc * kTN + j;
      if (c < n) out[r * n + c] = acc[i][j];
    }
  }
}

// out[e] = act(P[0][e] + P[1][e] + ... + P[nk-1][e]), left to right.
__global__ void __launch_bounds__(kSumThreads)
mm_partials_sum_kernel(const float* __restrict__ partials, float* __restrict__ out,
                       int64_t mn, int nk, int act) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kSumThreads;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kSumThreads + threadIdx.x; e < mn;
       e += stride) {
    float acc = partials[e];
    for (int l = 1; l < nk; ++l) acc += partials[l * mn + e];
    out[e] = octo::activate(acc, act);
  }
}

}  // namespace

extern "C" int mm_unfused_partials_launch(const void* x, const void* w, void* partials,
                                          int m, int k, int n, int bk, void* stream) {
  const int nk = (k + bk - 1) / bk;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, nk);
  mm_partials_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(partials), m, k, n, bk);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mm_partials_sum_launch(const void* partials, void* out, int64_t mn, int nk,
                                      int act, void* stream) {
  const int64_t blocks = (mn + kSumThreads - 1) / kSumThreads;
  const int grid = static_cast<int>(blocks < 65535 * 16 ? blocks : 65535 * 16);
  mm_partials_sum_kernel<<<grid, kSumThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partials), static_cast<float*>(out), mn, nk, act);
  return static_cast<int>(cudaGetLastError());
}
