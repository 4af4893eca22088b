// mm_fused: blocked f32 (M,K) @ (K,N) with the accumulator kept on chip
// across K and the activation in the epilogue.
//
// Replaces src/repro/kernels/arype_matmul/arype_matmul.py:mm_fused (body
// _mm_fused_kernel), whose f32 acc_ref stays in VMEM across the K grid axis.
//
// Bound: at the pipeline's shapes (a few MFLOP) the launch dominates.  At
// large shapes this SIMT f32 form is bound by the card's 67 TFLOP/s f32 rate,
// far under the tensor cores; 3xTF32 or wgmma is later work.  No TF32 here:
// the reference computes in full f32.
//
// Design: a 64x64 output tile per block of 256 threads, each thread holding a
// 4x4 accumulator in registers (the VMEM acc_ref's place).  x and w tiles of
// depth 16 are staged in shared memory per K step.  Ragged M, N and K edges
// are masked (zero-filled loads, guarded stores), so the wrapper pads nothing.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16, kTM = 4, kTN = 4;
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256

__global__ void __launch_bounds__(kThreads)
mm_fused_kernel(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ out, int m, int k, int n, int act) {
  __shared__ float xs[kBK][kBM];  // transposed x tile: xs[depth][row]
  __shared__ float ws[kBK][kBN];
  const int tid = threadIdx.x;
  const int tr = tid / (kBN / kTN);
  const int tc = tid % (kBN / kTN);
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int col0 = blockIdx.x * kBN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      const int64_t gr = row0 + r;
      const int gc = k0 + c;
      xs[c][r] = (gr < m && gc < k) ? x[gr * k + gc] : 0.f;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN, c = i % kBN;
      const int gr = k0 + r, gc = col0 + c;
      ws[r][c] = (gr < k && gc < n) ? w[static_cast<int64_t>(gr) * n + gc] : 0.f;
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

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int64_t r = row0 + tr * kTM + i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = col0 + tc * kTN + j;
      if (c < n) out[r * n + c] = octo::activate(acc[i][j], act);
    }
  }
}

}  // namespace

extern "C" int mm_fused_launch(const void* x, const void* w, void* out, int m,
                               int k, int n, int act, void* stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  mm_fused_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), m, k, n, act);
  return static_cast<int>(cudaGetLastError());
}
