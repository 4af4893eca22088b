// vpe_mm: small/skinny (M,K) @ (K,N) with a fused activation: x f32 or bf16
// (the LM's activations), w f32, the sum and the activation in f32, the
// output f32 or bf16, rounded once to nearest even.
//
// Replaces src/repro/kernels/vpe_smallmm/vpe_smallmm.py:vpe_mm (body
// _vpe_kernel), the VPU broadcast-multiply + reduce over K.
//
// Two kernels sit behind the one entry point vpe_mm_launch, picked by
// kernels/vpe_smallmm/ops.py:vpe_plan from the shape; every call is one launch.
//
// One to eight rows (batch-1 LM decode: a one-row projection fills an eighth
// of the modelled array and its M*K*N fits the VPE's cap, so the router places
// it here).  Bound: bytes, the K*N f32 weights read once ((1, 1024, 2048):
// 8.4 MB, 2.5 us).  One thread an output would run a K-deep FMA chain on
// N/256 CTAs (8 of the 132 SMs at N 2048), so this path launches the cluster
// split-K of skinny.cuh, with the slab width and K ranks mm_fused_plan gives
// (K, N): the same code, plan and K order as mm_fused at M <= 8, so the two
// engines give the same bits there and a row does not depend on M.
//
// More than eight rows (the pipelines' MLP and conv1: M 1024-5120, K 3-12, N
// 2-32).  Bound: the launch; past it, reading x (M*K*4 bytes) and writing out
// (M*N*4 bytes), since each thread does K FMAs.  Design: one thread per output
// element, an f32 loop over K.  w is staged in shared memory when K*N*4 bytes
// fit in 48 KB, and read from global memory (cached) otherwise.  The ragged M
// edge is masked, so the wrapper pads nothing.
//
// A bf16 x element is read as its exact f32 value in both, so the mixed arm
// computes the f32 kernel's function on x.float(), bit for bit (the
// reference's _vpe_kernel casts both tiles to f32, vpe_smallmm.py:26-27).
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "skinny.cuh"

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
cudaError_t launch(const void* x, const void* w, void* out, int m, int k, int n, int act,
                   int bn, int split, cudaStream_t s) {
  auto xp = static_cast<const TX*>(x);
  auto wp = static_cast<const float*>(w);
  auto op = static_cast<TO*>(out);
  if (bn != 0) return octo::launch_skinny_plan(xp, wp, op, m, k, n, act, bn, split, s);
  const int64_t total = static_cast<int64_t>(m) * n;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  if (k * n <= kMaxStagedFloats) {
    vpe_mm_kernel<true, TX, TO>
        <<<blocks, kThreads, k * n * sizeof(float), s>>>(xp, wp, op, m, k, n, act);
  } else {
    vpe_mm_kernel<false, TX, TO><<<blocks, kThreads, 0, s>>>(xp, wp, op, m, k, n, act);
  }
  return cudaSuccess;
}

}  // namespace

// One launch on x of x_dtype into out of out_dtype (octo::Dtype: f32 x into
// f32, bf16 x into f32 or bf16; w f32): the one-thread-an-output kernel where
// bn is 0, else the skinny split-K in slabs of bn (64 or 128) columns over
// `split` K ranks (1..8), for 1 <= m <= 8 only.  Another plan or dtype pair is
// refused with cudaErrorInvalidValue and launches nothing.
extern "C" int vpe_mm_launch(const void* x, const void* w, void* out, int m, int k, int n,
                             int act, int bn, int split, int x_dtype, int out_dtype,
                             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  const bool skinny = bn != 0;
  if (skinny && (m < 1 || m > octo::kSkinnyRows || (bn != 64 && bn != 128) || split < 1 ||
                 split > octo::kMaxCluster))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  if (x_dtype == octo::kF32 && out_dtype == octo::kF32)
    err = launch<float, float>(x, w, out, m, k, n, act, bn, split, s);
  else if (x_dtype == octo::kBF16 && out_dtype == octo::kF32)
    err = launch<octo::bf16_bits, float>(x, w, out, m, k, n, act, bn, split, s);
  else if (x_dtype == octo::kBF16 && out_dtype == octo::kBF16)
    err = launch<octo::bf16_bits, bf16>(x, w, out, m, k, n, act, bn, split, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}
