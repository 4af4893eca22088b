// mm_fused_q: int8 blocked (M,K) @ (K,N) with an int32 accumulator kept on
// chip across K, and the per-channel dequant and the activation in the
// epilogue, from f32 operands in one launch.
//
// Replaces src/repro/kernels/arype_matmul/arype_matmul.py:mm_fused_q (body
// _mm_fused_q_kernel, whose int32 acc_ref stays in VMEM across the K grid
// axis) together with the quantize, pad and slice ops its wrapper
// (ops.py:arype_matmul_q) runs around it.
//
// Bound: at the pipeline's shapes (a few million int8 operations) the launch
// dominates.  At large shapes this SIMT __dp4a form is bound by the integer
// pipes, far under the tensor cores' int8 rate; mma.sync s8 / wgmma and TMA
// are later work.
//
// Design: mm_fused.cu's tiling — a 64x64 output tile per block of 256
// threads, each thread holding a 4x4 int32 accumulator in registers (the
// VMEM acc_ref's place).  Each K step stages a 64x32 x tile and a 32x64 w
// tile in shared memory already quantized, four int8 codes along K packed
// per 32-bit word, so every element is divided once per tile load and not
// once per use; the inner loop is one __dp4a per quad.  Ragged M, N and K
// load zero codes (exact: they add zero products) and stores are guarded, so
// the wrapper pads nothing.  The epilogue writes
// (float)acc * (scale_x * scale_w[n]) through the activation.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 32, kTM = 4, kTN = 4;
constexpr int kQuads = kBK / 4;                      // packed words along K
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256

// Four int8 codes in one word, the first in the low byte (__dp4a's order).
__device__ __forceinline__ int pack4(int c0, int c1, int c2, int c3) {
  const unsigned u = (static_cast<unsigned>(c0) & 0xffu) |
                     ((static_cast<unsigned>(c1) & 0xffu) << 8) |
                     ((static_cast<unsigned>(c2) & 0xffu) << 16) |
                     ((static_cast<unsigned>(c3) & 0xffu) << 24);
  return static_cast<int>(u);
}

__global__ void __launch_bounds__(kThreads)
mm_fused_q_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float scale_x, const float* __restrict__ scale_w,
                  float* __restrict__ out, int m, int k, int n, int act) {
  __shared__ int xs[kQuads][kBM];  // x codes: xs[quad][row]
  __shared__ int ws[kQuads][kBN];  // w codes: ws[quad][col]
  const int tid = threadIdx.x;
  const int tr = tid / (kBN / kTN);
  const int tc = tid % (kBN / kTN);
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int col0 = blockIdx.x * kBN;

  int acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    for (int i = tid; i < kBM * kQuads; i += kThreads) {
      const int r = i / kQuads, q = i % kQuads;
      const int64_t gr = row0 + r;
      int c[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int gk = k0 + 4 * q + t;
        c[t] = (gr < m && gk < k) ? octo::quantize_code(x[gr * k + gk], scale_x) : 0;
      }
      xs[q][r] = pack4(c[0], c[1], c[2], c[3]);
    }
    for (int i = tid; i < kQuads * kBN; i += kThreads) {
      const int q = i / kBN, cl = i % kBN;
      const int gc = col0 + cl;
      const float sw = gc < n ? scale_w[gc] : 1.f;
      int c[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int gk = k0 + 4 * q + t;
        c[t] = (gc < n && gk < k)
                   ? octo::quantize_code(w[static_cast<int64_t>(gk) * n + gc], sw)
                   : 0;
      }
      ws[q][cl] = pack4(c[0], c[1], c[2], c[3]);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      int a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = xs[q][tr * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = ws[q][tc * kTN + j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int c = col0 + tc * kTN + j;
    if (c >= n) continue;
    const float dq = scale_x * scale_w[c];
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int64_t r = row0 + tr * kTM + i;
      if (r < m) out[r * n + c] = octo::activate(static_cast<float>(acc[i][j]) * dq, act);
    }
  }
}

}  // namespace

extern "C" int mm_fused_q_launch(const void* x, const void* w, float scale_x,
                                 const void* scale_w, void* out, int m, int k,
                                 int n, int act, void* stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  mm_fused_q_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), scale_x,
      static_cast<const float*>(scale_w), static_cast<float*>(out), m, k, n, act);
  return static_cast<int>(cudaGetLastError());
}
