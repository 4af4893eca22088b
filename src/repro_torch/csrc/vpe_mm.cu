// vpe_mm: small/skinny (M,K) @ (K,N) with a fused activation: x f32 or bf16
// (the LM's activations), w f32, the sum and the activation in f32, the
// output f32 or bf16, rounded once to nearest even.
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
// A bf16 x element is read as its exact f32 value, so the mixed arm computes
// the f32 kernel's function on x.float(), bit for bit (the reference's
// _vpe_kernel casts both tiles to f32, vpe_smallmm.py:26-27).  The LM reaches
// it at batch 1: a one-row projection fills an eighth of the modelled array
// and its M*K*N fits the VPE's cap, so the router places it here.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStagedFloats = 48 * 1024 / 4;

template <bool kStageW, typename TX, typename TO>
__global__ void __launch_bounds__(kThreads)
vpe_mm_kernel(const TX* __restrict__ x, const float* __restrict__ w, TO* __restrict__ out,
              int m, int k, int n, int act) {
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
  const TX* xr = x + row * k;
  float acc = 0.f;
  for (int kk = 0; kk < k; ++kk) acc = fmaf(octo::to_f32(xr[kk]), wp[kk * n + col], acc);
  octo::put(out + idx, octo::activate(acc, act));
}

template <typename TX, typename TO>
void launch(const void* x, const void* w, void* out, int m, int k, int n, int act,
            cudaStream_t s) {
  const int64_t total = static_cast<int64_t>(m) * n;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  auto xp = static_cast<const TX*>(x);
  auto wp = static_cast<const float*>(w);
  auto op = static_cast<TO*>(out);
  if (k * n <= kMaxStagedFloats) {
    vpe_mm_kernel<true, TX, TO>
        <<<blocks, kThreads, k * n * sizeof(float), s>>>(xp, wp, op, m, k, n, act);
  } else {
    vpe_mm_kernel<false, TX, TO><<<blocks, kThreads, 0, s>>>(xp, wp, op, m, k, n, act);
  }
}

}  // namespace

// x of x_dtype, out of out_dtype (octo::Dtype: f32 x into f32, bf16 x into f32
// or bf16; w f32); another pair is refused with cudaErrorInvalidValue and
// launches nothing.
extern "C" int vpe_mm_launch(const void* x, const void* w, void* out, int m, int k, int n,
                             int act, int x_dtype, int out_dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (x_dtype == octo::kF32 && out_dtype == octo::kF32)
    launch<float, float>(x, w, out, m, k, n, act, s);
  else if (x_dtype == octo::kBF16 && out_dtype == octo::kF32)
    launch<octo::bf16_bits, float>(x, w, out, m, k, n, act, s);
  else if (x_dtype == octo::kBF16 && out_dtype == octo::kBF16)
    launch<octo::bf16_bits, bf16>(x, w, out, m, k, n, act, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
