// vpe_mm_q: int8 small/skinny (M,K) @ (K,N) with int32 accumulation, the
// per-channel dequant and a fused activation, from f32 operands in one launch.
//
// Replaces src/repro/kernels/vpe_smallmm/vpe_smallmm.py:vpe_mm_q (body
// _vpe_q_kernel) together with the quantize, pad and slice ops its wrapper
// (ops.py:vpe_matmul_q) runs around it: this kernel reads the f32 x and w,
// quantizes both on load, and writes the f32 output.
//
// Bound: at the shapes the router sends here (K*N small, M up to a few
// thousand rows) the launch dominates; past it, reading x (M*K*4 bytes) and
// writing out (M*N*4 bytes), since each thread does K integer multiply-adds.
//
// Design: one thread per output element.  The K x N weight codes are
// quantized once per block into shared memory when they fit 48 KB (else each
// thread quantizes the weights it reads); each thread quantizes its x row in
// registers as it reads it.  The sum is int32 and exact (the wrapper checks
// K * 127^2 < 2^31), so no summation order can change it.  The output is
// (float)acc * (scale_x * scale_w[n]), one f32 product as the reference's
// dequant row, then the activation.  The ragged M edge is masked.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStagedCodes = 48 * 1024 / 4;

template <bool kStageW>
__global__ void __launch_bounds__(kThreads)
vpe_mm_q_kernel(const float* __restrict__ x, const float* __restrict__ w,
                float scale_x, const float* __restrict__ scale_w,
                float* __restrict__ out, int m, int k, int n, int act) {
  extern __shared__ int wq_s[];
  if (kStageW) {
    for (int i = threadIdx.x; i < k * n; i += kThreads)
      wq_s[i] = octo::quantize_code(w[i], scale_w[i % n]);
    __syncthreads();
  }
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<int64_t>(m) * n) return;
  const int64_t row = idx / n;
  const int col = static_cast<int>(idx % n);
  const float sw = scale_w[col];
  const float* xr = x + row * k;
  int acc = 0;
  for (int kk = 0; kk < k; ++kk) {
    const int xq = octo::quantize_code(xr[kk], scale_x);
    const int wq = kStageW ? wq_s[kk * n + col]
                           : octo::quantize_code(w[static_cast<int64_t>(kk) * n + col], sw);
    acc += xq * wq;
  }
  out[idx] = octo::activate(static_cast<float>(acc) * (scale_x * sw), act);
}

}  // namespace

extern "C" int vpe_mm_q_launch(const void* x, const void* w, float scale_x,
                               const void* scale_w, void* out, int m, int k,
                               int n, int act, void* stream) {
  const int64_t total = static_cast<int64_t>(m) * n;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  auto s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const float*>(x);
  auto wp = static_cast<const float*>(w);
  auto sp = static_cast<const float*>(scale_w);
  auto op = static_cast<float*>(out);
  if (static_cast<int64_t>(k) * n <= kMaxStagedCodes) {
    vpe_mm_q_kernel<true><<<blocks, kThreads, k * n * sizeof(int), s>>>(
        xp, wp, scale_x, sp, op, m, k, n, act);
  } else {
    vpe_mm_q_kernel<false><<<blocks, kThreads, 0, s>>>(xp, wp, scale_x, sp, op,
                                                       m, k, n, act);
  }
  return static_cast<int>(cudaGetLastError());
}
