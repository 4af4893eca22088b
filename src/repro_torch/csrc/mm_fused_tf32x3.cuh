// mm_fused's variants A and B (see mm_fused.cu) on x of f32 or bf16 and w of one
// type TW: launch_on_w<TW>, the skinny split-K (skinny.cuh) or variant B, the
// 3xTF32 tensor-core GEMM.  mm_fused.cu instantiates it for f32 w and
// mm_fused_bf16w.cu for bf16 w, as mm_fused_bf16w: two sources, which the
// build compiles in parallel, since each weight type takes 46 kernels (the
// tf32x3 tiles in their copy widths, the skinny slabs, every x and out type).
#pragma once

#include <atomic>

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "gemm_tiles.cuh"
#include "skinny.cuh"

namespace octo {

// launch_on_w on bf16 w, defined in mm_fused_bf16w.cu.
cudaError_t mm_fused_bf16w(const void* x, int x_dtype, const bf16_bits* w, void* out,
                           int out_dtype, int m, int k, int n, int act, int tile, int split,
                           cudaStream_t s);

namespace {

// The tile's 3xTF32 sum over all of K (gemm_tiles.cuh), then the activation,
// stored as out_dtype.
template <int BM, int BN, int WM, int WN, int kMinBlocks, int kCopyX, int kCopyW, typename TA,
          typename TW>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32, kMinBlocks)
mm_tf32x3_kernel(const TA* __restrict__ x, const TW* __restrict__ w, void* __restrict__ out,
                 int out_dtype, int m, int k, int n, int act) {
  extern __shared__ __align__(16) float ring[];
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int col0 = blockIdx.x * BN;
  float acc[WM / 16][WN / 8][4] = {};
  tf32x3_sum<BM, BN, WM, WN, kCopyX, kCopyW>(ring, x, w, m, k, n, row0, col0, 0, k, acc);
  store_tile_as<BM, BN, WM, WN>(out, out_dtype, acc, m, n, row0, col0,
                                [act](float v, int, int) { return activate(v, act); });
}

// One launch of tile T (Tile) in the copies C (Copies)
template <typename T, typename C, typename TA, typename TW>
cudaError_t launch_tf32x3(const TA* x, const TW* w, void* out, int out_dtype, int m, int k,
                          int n, int act, cudaStream_t stream) {
  constexpr int kSmem = ring_floats<T::BM, T::BN>() * 4;
  static_assert(kSmem * T::kMinBlocks <= 227 * 1024, "ring exceeds the SM's shared memory");
  auto kernel =
      mm_tf32x3_kernel<T::BM, T::BN, T::WM, T::WN, T::kMinBlocks, C::X, C::W, TA, TW>;
  static std::atomic<uint64_t> opted{0};
  const cudaError_t opt_in = opt_in_smem(kernel, kSmem, opted);
  if (opt_in != cudaSuccess) return opt_in;
  const dim3 grid((n + T::BN - 1) / T::BN, (m + T::BM - 1) / T::BM);
  kernel<<<grid, T::kThreads, kSmem, stream>>>(x, w, out, out_dtype, m, k, n, act);
  return cudaSuccess;
}

// One launch of tile `tile` on x of x_dtype and w of TW into out of out_dtype,
// in the widest copies x's and w's rows and bases allow.
template <typename TW>
cudaError_t tf32x3_launch(const void* x, int x_dtype, const TW* w, void* out, int out_dtype,
                          int m, int k, int n, int act, int tile, cudaStream_t s) {
  return with_type(x_dtype, [&](auto tx) {
    using TA = typename decltype(tx)::type;
    const TA* xp = static_cast<const TA*>(x);
    const int copy_x = copy_width(xp, k, sizeof(TA));
    const int copy_w = w_copy_width(w, n, sizeof(TW));
    return with_tile(tile, [&](auto t) {
      return with_copies<TA, TW>(copy_x, copy_w, [&](auto c) {
        return launch_tf32x3<decltype(t), decltype(c)>(xp, w, out, out_dtype, m, k, n, act, s);
      });
    });
  });
}

// One launch of mm_fused's plan (tile an index into MM_FUSED_TILES, 0-1
// skinny, 2-4 tf32x3; split the skinny variant's K ranks) on x of x_dtype and
// w of TW into out of out_dtype.  The entry point has checked the plan.
template <typename TW>
cudaError_t launch_on_w(const void* x, int x_dtype, const TW* w, void* out, int out_dtype, int m,
                        int k, int n, int act, int tile, int split, cudaStream_t s) {
  if (tile >= 2) return tf32x3_launch(x, x_dtype, w, out, out_dtype, m, k, n, act, tile - 2, s);
  const int bn = tile == 0 ? 64 : 128;
  return with_type(x_dtype, [&](auto tx) {
    const auto* xp = static_cast<const typename decltype(tx)::type*>(x);
    return out_dtype == kBF16
               ? launch_skinny_plan(xp, w, static_cast<__nv_bfloat16*>(out), m, k, n, act, bn,
                                    split, s)
               : launch_skinny_plan(xp, w, static_cast<float*>(out), m, k, n, act, bn, split, s);
  });
}

}  // namespace
}  // namespace octo
