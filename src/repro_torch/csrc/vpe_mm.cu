// vpe_mm: small/skinny (M,K) @ (K,N) with a fused activation: x and w each
// f32 or bf16 (the LM's activations and weights), the sum and the activation
// in f32, the output f32 or bf16, rounded once to nearest even.
//
// Replaces src/repro/kernels/vpe_smallmm/vpe_smallmm.py:vpe_mm (body
// _vpe_kernel), the VPU broadcast-multiply + reduce over K.
//
// Two kernels sit behind the one entry point vpe_mm_launch, picked by
// kernels/vpe_smallmm/ops.py:vpe_plan from the shape; every call is one launch.
//
// One to eight rows (batch-1 LM decode: a one-row projection fills an eighth
// of the modelled array and its M*K*N fits the VPE's cap, so the router places
// it here).  Bound: bytes, the K*N weights read once ((1, 1024, 2048) in f32:
// 8.4 MB, 2.5 us).  One thread an output would run a K-deep FMA chain on
// N/256 CTAs (8 of the 132 SMs at N 2048), so this path launches the cluster
// split-K of skinny.cuh, with the slab width and K ranks mm_fused_plan gives
// (K, N): the same code, plan and K order as mm_fused at M <= 8, so the two
// engines give the same bits there and a row does not depend on M.
//
// More than eight rows (the pipelines' MLP and conv1: M 1024-5120, K 3-12, N
// 2-32).  Bound: the launch; past it, reading x (M*K*4 bytes) and writing out
// (M*N*4 bytes), since each thread does K FMAs.  Design: one thread per output
// element, an f32 loop over K.  w is staged in shared memory as f32 when K*N*4
// bytes fit in 48 KB, and read from global memory (cached) otherwise.  The
// ragged M edge is masked, so the wrapper pads nothing.
//
// A bf16 x or w element is read as its exact f32 value in both, so every pair
// of types computes the f32 kernel's function on x.float(), w.float(), bit
// for bit (the reference's _vpe_kernel casts both tiles to f32,
// vpe_smallmm.py:26-27).
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "skinny.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStagedFloats = 48 * 1024 / 4;

template <bool kStageW, typename TX, typename TW, typename TO>
__global__ void __launch_bounds__(kThreads)
vpe_mm_kernel(const TX* __restrict__ x, const TW* __restrict__ w, TO* __restrict__ out,
              int m, int k, int n, int act) {
  extern __shared__ float w_s[];
  if (kStageW) {
    for (int i = threadIdx.x; i < k * n; i += kThreads) w_s[i] = octo::to_f32(w[i]);
    __syncthreads();
  }
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<int64_t>(m) * n) return;
  const int64_t row = idx / n;
  const int col = static_cast<int>(idx % n);
  const TX* xr = x + row * k;
  float acc = 0.f;
  if (kStageW) {
    for (int kk = 0; kk < k; ++kk) acc = fmaf(octo::to_f32(xr[kk]), w_s[kk * n + col], acc);
  } else {
    for (int kk = 0; kk < k; ++kk)
      acc = fmaf(octo::to_f32(xr[kk]), octo::to_f32(w[static_cast<int64_t>(kk) * n + col]), acc);
  }
  octo::put(out + idx, octo::activate(acc, act));
}

template <typename TX, typename TW, typename TO>
cudaError_t launch(const TX* x, const TW* w, TO* out, int m, int k, int n, int act, int bn,
                   int split, cudaStream_t s) {
  if (bn != 0) return octo::launch_skinny_plan(x, w, out, m, k, n, act, bn, split, s);
  const int64_t total = static_cast<int64_t>(m) * n;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  if (k * n <= kMaxStagedFloats) {
    vpe_mm_kernel<true, TX, TW, TO>
        <<<blocks, kThreads, k * n * sizeof(float), s>>>(x, w, out, m, k, n, act);
  } else {
    vpe_mm_kernel<false, TX, TW, TO><<<blocks, kThreads, 0, s>>>(x, w, out, m, k, n, act);
  }
  return cudaSuccess;
}

}  // namespace

// One launch on x of x_dtype and w of w_dtype into out of out_dtype
// (octo::Dtype codes, each f32 or bf16: all eight pairs are built): the
// one-thread-an-output kernel where bn is 0, else the skinny split-K in slabs
// of bn (64 or 128) columns over `split` K ranks (1..8), for 1 <= m <= 8 only.
// Another plan or an unknown dtype code is refused with cudaErrorInvalidValue
// and launches nothing.
extern "C" int vpe_mm_launch(const void* x, const void* w, void* out, int m, int k, int n,
                             int act, int bn, int split, int x_dtype, int w_dtype,
                             int out_dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const bool skinny = bn != 0;
  if (skinny && (m < 1 || m > octo::kSkinnyRows || (bn != 64 && bn != 128) || split < 1 ||
                 split > octo::kMaxCluster))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      octo::with_dtypes(x_dtype, w_dtype, out_dtype, [&](auto tx, auto tw, auto to) {
        using TX = typename decltype(tx)::type;
        using TW = typename decltype(tw)::type;
        using TO = typename decltype(to)::type;
        return launch(static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<TO*>(out),
                      m, k, n, act, bn, split, s);
      });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
