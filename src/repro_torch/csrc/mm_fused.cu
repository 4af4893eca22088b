// mm_fused: (M,K) @ (K,N) -> (M,N) with the sum of every output kept on chip
// across K and the activation applied once, in the epilogue: x and w each f32
// or bf16 (the LM's activations and weights), the sum and the activation in
// f32, the output f32 or bf16, rounded once on its single write.
//
// Replaces src/repro/kernels/arype_matmul/arype_matmul.py:mm_fused (body
// _mm_fused_kernel), whose f32 acc_ref stays in VMEM across the K grid axis.
// No K-block partial is ever written to device memory; that is what the
// unfused ablation (mm_unfused_partials.cu) does.
//
// Three kernels sit behind the one entry point mm_fused_launch; the shape,
// the operands' types and their alignment pick one
// (kernels/arype_matmul/ops.py:mm_fused_plan), and every call is one launch.
// Ragged M, N and K edges are masked here, so the wrapper pads nothing.
//
// Variant A, skinny M (M <= 8: LM decode and the LM head).  Bound: bytes, the
// K*N weights read once (4 or 2 bytes each).  Design: the cluster split-K of
// skinny.cuh, which vpe_mm.cu launches too at M <= 8, from the same plan.
//
// Variant B, the rest of M > 8 (f32 and mixed prefill, the pipelines, Table 6,
// the training products; bf16 x bf16 operands TMA cannot load).  Bound:
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
// Variant C, bf16 x on bf16 w at M > 8 where TMA can load both (K and N
// multiples of 8, 16-byte aligned bases: every served bf16 prefill).  Bound:
// operations, 2MKN over the bf16 tensor cores' 989 TFLOP/s.  Design: bf16
// wgmma fed by TMA through a 5-stage mbarrier ring, one producer and one or
// two consumer warpgroups, each 64-deep K tile's sum promoted
// (mm_fused_wgmma.cu).  Its K order (k16 steps, 64-deep tiles) is not
// variant B's, so it does not equal the f32 arm bit for bit; the card holds
// it to an f64 product of the same operands instead.
//
// The bf16 arms (reference: jnp.dot of any pair of types with
// preferred_element_type=f32, arype_matmul.py:33-35, rounded once to
// out_dtype or x.dtype, :44 and :111).  A bf16 value is exactly an f32 and a
// tf32 value, so on variants A and B every (x, w) pair of types computes the
// f32 kernel's function on x.float(), w.float(), bit for bit: the skinny
// one converts x while staging it and streams a bf16 w as 2-byte values
// widened in registers (skinny.cuh); the tf32x3 one lands bf16 tiles (half
// the bytes) and splits them into hi = bits << 16, lo = 0, so it skips the
// zero products: two mma.sync a step where one operand is bf16, one for
// bf16 x bf16 (2 and 1 x 2MKN tf32 products against the f32 arm's 3).  On
// both, the K order and the tile plan come from the shape alone, whatever
// the types.  A bf16 x with odd K or a base that is only 2-byte aligned, and
// a bf16 w whose N is not a multiple of 8 or whose base is not 16-byte
// aligned, have no cp.async copy; their tiles load synchronously, element by
// element (bf16 x bf16 there stays on variant B).  A bf16 output is rounded
// to nearest even, as torch's .to and XLA's astype.
//
// Left for later: wgmma for the f32 and mixed arms (it takes tf32 B only
// K-major, so the weights would need another layout), and TMA loads and warp
// specialisation on variant B.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "mm_fused_tf32x3.cuh"

namespace octo {
// Variant C (mm_fused_wgmma.cu): bf16 x, bf16 w, tile an index into
// ops.py:WGMMA_TILES.
cudaError_t mm_fused_wgmma(const void* x, const void* w, void* out, int out_dtype, int m, int k,
                           int n, int act, int tile, cudaStream_t s);
}  // namespace octo

// One launch of the plan's tile, an index into kernels/arype_matmul/ops.py:
// MM_FUSED_TILES (0-1 skinny, 8 rows by 64 or 128 columns; 2-4 tf32x3, 32 rows
// by 128, 64 or 32; 5-8 wgmma, 128 or 64 rows by 128 or 64), split over
// `split` K ranks, on x of x_dtype and w of w_dtype into out of out_dtype
// (octo::Dtype codes, each f32 or bf16: all eight pairs are built on the
// skinny and tf32x3 variants; wgmma takes bf16 x and w only).  A plan this
// file cannot run (a tile out of range or of the wrong variant for M or the
// types, C outside 1..8 or not 1 past the skinny variant, operands wgmma's
// TMA cannot load, a grid past its limits, an unknown dtype code) is refused
// with cudaErrorInvalidValue and launches nothing.
extern "C" int mm_fused_launch(const void* x, const void* w, void* out, int m, int k, int n,
                               int act, int tile, int split, int x_dtype, int w_dtype,
                               int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool skinny = tile == 0 || tile == 1;
  const bool wgmma = tile >= 5;
  if (m <= 0 || n <= 0 || k < 0 || tile < 0 || tile > 8 || skinny != (m <= octo::kSkinnyRows) ||
      split < 1 || split > (skinny ? octo::kMaxCluster : 1) ||
      (!skinny && !wgmma && (m + 31) / 32 > 65535) ||
      (out_dtype != octo::kF32 && out_dtype != octo::kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (wgmma) {
    if (x_dtype == octo::kBF16 && w_dtype == octo::kBF16)
      err = octo::mm_fused_wgmma(x, w, out, out_dtype, m, k, n, act, tile - 5, s);
  } else if (w_dtype == octo::kF32) {
    err = octo::launch_on_w(x, x_dtype, static_cast<const float*>(w), out, out_dtype, m, k, n,
                            act, tile, split, s);
  } else if (w_dtype == octo::kBF16) {
    err = octo::mm_fused_bf16w(x, x_dtype, static_cast<const octo::bf16_bits*>(w), out,
                               out_dtype, m, k, n, act, tile, split, s);
  }
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}
