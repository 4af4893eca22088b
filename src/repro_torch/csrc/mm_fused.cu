// mm_fused: (M,K) @ (K,N) -> (M,N) with the sum of every output kept on chip
// across K and the activation applied once, in the epilogue: x f32 or bf16
// (the LM's activations), w f32, the sum and the activation in f32, the
// output f32 or bf16, rounded once on its single write.
//
// Replaces src/repro/kernels/arype_matmul/arype_matmul.py:mm_fused (body
// _mm_fused_kernel), whose f32 acc_ref stays in VMEM across the K grid axis.
// No K-block partial is ever written to device memory; that is what the
// unfused ablation (mm_unfused_partials.cu) does.
//
// Two kernels sit behind the one entry point mm_fused_launch; the shape alone
// picks one (kernels/arype_matmul/ops.py:mm_fused_plan), and every call is one
// launch.  Ragged M, N and K edges are masked here, so the wrapper pads nothing.
//
// Variant A, skinny M (M <= 8: LM decode and the LM head).  Bound: bytes, the
// K*N f32 weights read once.  Design: the cluster split-K of skinny.cuh, which
// vpe_mm.cu launches too at M <= 8, from the same plan.
//
// Variant B, everything else (M > 8: prefill, the pipelines, Table 6).  Bound:
// operations, 3 * 2MKN tf32 products over 495 TFLOP/s, or bytes at the
// pipelines' thin K.  Design: a 3xTF32 tensor-core GEMM on the 32-row tile
// skeleton of gemm_tiles.cuh, which mm_unfused_partials.cu shares: mma.sync
// m16n8k8 on each operand split at fragment load into hi = rna_tf32(v) and
// lo = rna_tf32(v - hi) (cvt.rna's rounding, done in integer ops); lo*hi +
// hi*lo + hi*hi accumulate at every k-step, which holds the f32 reference's
// rtol 1e-5 where one tf32 product misses it by some 20x.  The tensor cores'
// own f32 accumulation truncates, so its error grows with every step: carried
// over all of K = 3072 it missed rtol 1e-5 on the H100 (PERF.md).  So each
// 32-deep K tile sums from 0 in the tensor cores (12 mma steps) and is then
// promoted into the output's f32 sum with one round-to-nearest add.
// Tiles of 32 x BN x 32 (BN 128, 64 or 32, picked by shape) are fed by a
// 3-stage cp.async ring: 16-byte copies, zero-filled on ragged edges, or
// 4-byte copies of an operand whose rows or base are not 16-byte aligned (x
// at the tests' K = 5, w at the paper's N = 162).
// The shared tiles are padded so that the A fragments (one ldmatrix each) and
// the transposed B fragment reads (w is (K,N) with N contiguous, but tf32 mma
// takes B only as .col) are free of bank conflicts.  K is never split and its
// order never changes with the tile or M, so a row's result does not depend
// on M either.
//
// The mixed arm (bf16 x, f32 w; reference: jnp.dot of the pair promotes to
// f32, arype_matmul.py:33-35, rounded once to out_dtype, :44 and :111).  A
// bf16 value is exactly an f32 and a tf32 value, so both variants compute
// the f32 kernel's function on x.float(), bit for bit: the skinny one
// converts x while staging it (skinny.cuh); the tf32x3 one lands bf16 tiles (half the
// activation bytes) and splits them into hi = bits << 16, lo = 0, so it
// skips the zero lo*hi product and issues two mma.sync a step instead of
// three (2 x 2MKN tf32 products: its bound is two thirds of the f32 arm's).
// A bf16 x with odd K or a base that is only 2-byte aligned has no cp.async
// copy (4, 8 or 16 bytes); its tiles load synchronously, element by element.
// A bf16 output is rounded to nearest even, as torch's .to and XLA's astype.
//
// Left for later: wgmma (it takes tf32 B only K-major, so the weights would
// need another layout), TMA loads and warp specialisation.
#include <atomic>

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "gemm_tiles.cuh"
#include "skinny.cuh"

namespace {

// ----------------------------------------------------------------- variant B

// The tile's 3xTF32 sum over all of K (gemm_tiles.cuh), then the activation.
template <int BM, int BN, int WM, int WN, int kMinBlocks, int kCopyX, int kCopyW, typename TA,
          typename TO>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32, kMinBlocks)
mm_tf32x3_kernel(const TA* __restrict__ x, const float* __restrict__ w, TO* __restrict__ out,
                 int m, int k, int n, int act) {
  extern __shared__ __align__(16) float ring[];
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int col0 = blockIdx.x * BN;
  float acc[WM / 16][WN / 8][4] = {};
  octo::tf32x3_sum<BM, BN, WM, WN, kCopyX, kCopyW>(ring, x, w, m, k, n, row0, col0, 0, k, acc);
  octo::store_tile<BM, BN, WM, WN>(out, acc, m, n, row0, col0,
                                   [act](float v, int, int) { return octo::activate(v, act); });
}

// One launch of tile T (octo::Tile) in the copies C (octo::Copies)
template <typename T, typename C, typename TA, typename TO>
cudaError_t launch_tf32x3(const TA* x, const float* w, TO* out, int m, int k, int n, int act,
                          cudaStream_t stream) {
  constexpr int kSmem = octo::ring_floats<T::BM, T::BN>() * 4;
  static_assert(kSmem * T::kMinBlocks <= 227 * 1024, "ring exceeds the SM's shared memory");
  auto kernel =
      mm_tf32x3_kernel<T::BM, T::BN, T::WM, T::WN, T::kMinBlocks, C::X, C::W, TA, TO>;
  static std::atomic<uint64_t> opted{0};
  const cudaError_t opt_in = octo::opt_in_smem(kernel, kSmem, opted);
  if (opt_in != cudaSuccess) return opt_in;
  const dim3 grid((n + T::BN - 1) / T::BN, (m + T::BM - 1) / T::BM);
  kernel<<<grid, T::kThreads, kSmem, stream>>>(x, w, out, m, k, n, act);
  return cudaSuccess;
}

// One launch of the plan on x of TA into out of TO.
template <typename TA, typename TO>
cudaError_t launch_plan(const void* xp, const float* w, void* outp, int m, int k, int n, int act,
                        int tile, int split, cudaStream_t s) {
  const TA* x = static_cast<const TA*>(xp);
  TO* out = static_cast<TO*>(outp);
  if (tile <= 1)
    return octo::launch_skinny_plan(x, w, out, m, k, n, act, tile == 0 ? 64 : 128, split, s);
  const int copy_x = octo::copy_width(x, k, sizeof(TA));
  const bool vec_w = n % 4 == 0 && octo::aligned(w, 16);
  return octo::with_tile(tile - 2, [&](auto t) {
    auto launch = [&](auto c) {
      return launch_tf32x3<decltype(t), decltype(c)>(x, w, out, m, k, n, act, s);
    };
    return octo::with_copies<TA>(copy_x, vec_w, launch);
  });
}

}  // namespace

// One launch of the plan's tile, an index into kernels/arype_matmul/ops.py:
// MM_FUSED_TILES (0-1 skinny, 8 rows by 64 or 128 columns; 2-4 tf32x3, 32 rows
// by 128, 64 or 32), split over `split` K ranks, on x of x_dtype into out of
// out_dtype (octo::Dtype: f32 x into f32, bf16 x into f32 or bf16; w is f32;
// f32 x into bf16 runs on no path and is not built).  A plan this file
// cannot run (a tile out of range or of the wrong variant for M, C outside
// 1..8 or not 1 for tf32x3, a grid past its limits, another dtype pair) is
// refused with cudaErrorInvalidValue and launches nothing.
extern "C" int mm_fused_launch(const void* xp, const void* wp, void* outp, int m, int k, int n,
                               int act, int tile, int split, int x_dtype, int out_dtype,
                               void* stream) {
  const float* w = static_cast<const float*>(wp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool skinny = tile == 0 || tile == 1;
  const bool dtypes = x_dtype == octo::kBF16 ? out_dtype == octo::kF32 || out_dtype == octo::kBF16
                                             : x_dtype == octo::kF32 && out_dtype == octo::kF32;
  if (m <= 0 || n <= 0 || k < 0 || tile < 0 || tile > 4 || skinny != (m <= octo::kSkinnyRows) ||
      split < 1 || split > (skinny ? octo::kMaxCluster : 1) || (m + 31) / 32 > 65535 || !dtypes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (x_dtype == octo::kF32)
    err = launch_plan<float, float>(xp, w, outp, m, k, n, act, tile, split, s);
  else
    err = out_dtype == octo::kF32
              ? launch_plan<octo::bf16_bits, float>(xp, w, outp, m, k, n, act, tile, split, s)
              : launch_plan<octo::bf16_bits, __nv_bfloat16>(xp, w, outp, m, k, n, act, tile,
                                                            split, s);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}
