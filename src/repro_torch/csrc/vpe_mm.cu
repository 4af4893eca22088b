// vpe_mm: small/skinny f32 (M,K) @ (K,N) with a fused activation.
//
// Replaces src/repro/kernels/vpe_smallmm/vpe_smallmm.py:vpe_mm (body
// _vpe_kernel), the VPU broadcast-multiply + reduce over K.
//
// Bound: at the shapes the router sends here (K*N small, M up to a few
// thousand rows) the launch dominates; past it, reading x (M*K*4 bytes) and
// writing out (M*N*4 bytes) bound it, since each thread does K FMAs.
//
// Design: one thread per output element, an f32 loop over K.  w is staged in
// shared memory when K*N*4 bytes fit in 48 KB, and read from global memory
// (cached) otherwise.  The ragged M edge is masked, so the wrapper pads nothing.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStagedFloats = 48 * 1024 / 4;

template <bool kStageW>
__global__ void __launch_bounds__(kThreads)
vpe_mm_kernel(const float* __restrict__ x, const float* __restrict__ w,
              float* __restrict__ out, int m, int k, int n, int act) {
  extern __shared__ float w_s[];
  if (kStageW) {
    for (int i = threadIdx.x; i < k * n; i += kThreads) w_s[i] = w[i];
    __syncthreads();
  }
  const float* wp = kStageW ? w_s : w;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<int64_t>(m) * n) return;
  const int64_t row = idx / n;
  const int col = static_cast<int>(idx % n);
  const float* xr = x + row * k;
  float acc = 0.f;
  for (int kk = 0; kk < k; ++kk) acc = fmaf(xr[kk], wp[kk * n + col], acc);
  out[idx] = octo::activate(acc, act);
}

}  // namespace

extern "C" int vpe_mm_launch(const void* x, const void* w, void* out, int m,
                             int k, int n, int act, void* stream) {
  const int64_t total = static_cast<int64_t>(m) * n;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  auto s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const float*>(x);
  auto wp = static_cast<const float*>(w);
  auto op = static_cast<float*>(out);
  if (k * n <= kMaxStagedFloats) {
    vpe_mm_kernel<true><<<blocks, kThreads, k * n * sizeof(float), s>>>(
        xp, wp, op, m, k, n, act);
  } else {
    vpe_mm_kernel<false><<<blocks, kThreads, 0, s>>>(xp, wp, op, m, k, n, act);
  }
  return static_cast<int>(cudaGetLastError());
}
