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
// Bound: bytes at the pipeline's and Table 6's thin K.  x and w are read
// once each, the partials written once and read once more, the output written
// once; a few MB, so the launches and the first tile's load latency dominate.
// The products are 3 x 2MKN tf32 operations over 495 TFLOP/s.
//
// Design: the partials kernel is mm_fused.cu's 3xTF32 tensor-core mainloop
// (gemm_tiles.cuh: 32 x BN tiles, the 3-stage cp.async ring, every 32-deep K
// tile's sum promoted into an f32 sum) over the CTA's own K block, with one
// grid slice (blockIdx.z) per block: one CTA per (column tile, row tile, K
// block), so a deep K fills the card even where the tiles alone would not.
// The K range and the store (the raw block sum to partials[l], no activation)
// are its only differences from mm_fused's tf32x3 variant.  The tiles start
// at l * bk, so at bk = 32 each partial is the fused kernel's promoted tile
// sum, the sum pass adds them left to right from the first as mm_fused's
// promotion does, and the unfused product equals mm_fused's bit for bit for
// M > 8.  Ragged M, N and block edges are masked (zero-filled loads, guarded
// stores), so the wrapper pads nothing; x takes 4-byte copies where bk or K
// is not a multiple of 4 or its base is unaligned, w where N or its base is.
//
// The sum pass is bound by bytes (the partials read, the output written); one
// thread an element, or four in 16-byte loads where M*N is a multiple of 4,
// grid-strided.  At these sizes its launch costs about as much as its bytes,
// so it is a programmatic dependent launch: the partials kernel lets it
// launch at once, and it waits (griddepcontrol.wait) until the partials
// kernel has finished and its partials are visible in device memory before
// it reads them.  The round trip and the two launches stay; only the sum's
// launch latency overlaps the partials kernel.
#include <atomic>

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "gemm_tiles.cuh"

namespace {

constexpr int kSumThreads = 256;

template <int BM, int BN, int WM, int WN, int kMinBlocks, int kCopyX, int kCopyW>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32, kMinBlocks)
mm_partials_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ partials, int m, int k, int n, int bk) {
  extern __shared__ __align__(16) float ring[];
  // the sum pass may launch now; it waits for this grid to finish (below)
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int col0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * bk;
  const int kend = min(k - kbeg, bk) + kbeg;
  float acc[WM / 16][WN / 8][4] = {};
  octo::tf32x3_sum<BM, BN, WM, WN, kCopyX, kCopyW>(ring, x, w, m, k, n, row0, col0, kbeg, kend,
                                                    acc);
  octo::store_tile<BM, BN, WM, WN>(partials + static_cast<int64_t>(blockIdx.z) * m * n, acc, m,
                                   n, row0, col0, [](float v, int, int) { return v; });
}

template <typename T, typename C>
cudaError_t launch_partials(const float* x, const float* w, float* partials, int m, int k, int n,
                            int bk, cudaStream_t stream) {
  constexpr int kSmem = octo::ring_floats<T::BM, T::BN>() * 4;
  static_assert(kSmem * T::kMinBlocks <= 227 * 1024, "ring exceeds the SM's shared memory");
  auto kernel = mm_partials_kernel<T::BM, T::BN, T::WM, T::WN, T::kMinBlocks, C::X, C::W>;
  static std::atomic<uint64_t> opted{0};
  const cudaError_t opt_in = octo::opt_in_smem(kernel, kSmem, opted);
  if (opt_in != cudaSuccess) return opt_in;
  const dim3 grid((n + T::BN - 1) / T::BN, (m + T::BM - 1) / T::BM, (k + bk - 1) / bk);
  kernel<<<grid, T::kThreads, kSmem, stream>>>(x, w, partials, m, k, n, bk);
  return cudaSuccess;
}

__device__ __forceinline__ void add(float& a, float b) { a += b; }
__device__ __forceinline__ void add(float4& a, float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
__device__ __forceinline__ float activate(float v, int act) { return octo::activate(v, act); }
__device__ __forceinline__ float4 activate(float4 v, int act) {
  return make_float4(octo::activate(v.x, act), octo::activate(v.y, act),
                     octo::activate(v.z, act), octo::activate(v.w, act));
}

// out[e] = act(P[0][e] + P[1][e] + ... + P[nk-1][e]), left to right, over
// elements of V (a float, or four in one 16-byte load where M*N allows).
template <typename V>
__global__ void __launch_bounds__(kSumThreads)
mm_partials_sum_kernel(const V* __restrict__ partials, V* __restrict__ out, int64_t mn, int nk,
                       int act) {
  // launched early behind the partials kernel (programmatic dependent
  // launch): wait until it has finished and its partials are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kSumThreads;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kSumThreads + threadIdx.x; e < mn;
       e += stride) {
    V acc = partials[e];
    for (int l = 1; l < nk; ++l) add(acc, partials[l * mn + e]);
    out[e] = activate(acc, act);
  }
}

template <typename V>
cudaError_t launch_sum(const void* partials, void* out, int64_t mn, int nk, int act,
                       cudaStream_t stream) {
  const int64_t blocks = (mn + kSumThreads - 1) / kSumThreads;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks < 65535 * 16 ? blocks : 65535 * 16));
  cfg.blockDim = dim3(kSumThreads);
  cfg.stream = stream;
  // its launch overlaps the partials kernel's tail; griddepcontrol.wait keeps
  // the order, so the partials still go through device memory first
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, mm_partials_sum_kernel<V>, static_cast<const V*>(partials),
                            static_cast<V*>(out), mn, nk, act);
}

}  // namespace

// One launch of the partials kernel with the plan's tile, an index into
// kernels/arype_matmul/ops.py:TF32X3_TILES.  A plan this file cannot run (a
// tile out of range, bk < 1, a grid past its limits) is refused with
// cudaErrorInvalidValue and launches nothing.
extern "C" int mm_unfused_partials_launch(const void* xp, const void* wp, void* partials,
                                          int m, int k, int n, int bk, int tile, void* stream) {
  const float* x = static_cast<const float*>(xp);
  const float* w = static_cast<const float*>(wp);
  float* p = static_cast<float*>(partials);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || k <= 0 || bk <= 0 || (m + 31) / 32 > 65535 ||
      (k - 1) / bk + 1 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // each K block's rows start bk floats in: 16-byte copies need bk % 4 == 0
  const int copy_x = bk % 4 == 0 ? octo::copy_width(x, k, sizeof(float)) : 4;
  const int copy_w = octo::w_copy_width(w, n, sizeof(float));
  const cudaError_t err = octo::with_tile(tile, [&](auto t) {
    return octo::with_copies<float, float>(copy_x, copy_w, [&](auto c) {
      return launch_partials<decltype(t), decltype(c)>(x, w, p, m, k, n, bk, s);
    });
  });
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

extern "C" int mm_partials_sum_launch(const void* partials, void* out, int64_t mn, int nk,
                                      int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = mn % 4 == 0 && octo::aligned(partials, 16) && octo::aligned(out, 16);
  return static_cast<int>(vec ? launch_sum<float4>(partials, out, mn / 4, nk, act, s)
                              : launch_sum<float>(partials, out, mn, nk, act, s));
}
