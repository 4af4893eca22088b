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
// Variant A, skinny M (M <= 8: LM decode and the LM head).  Bound: bytes.  The
// K*N weights are read once and M*K + M*N are small, so the least time is
// 4*K*N bytes over 3.35 TB/s (the head's 622 MB: 0.19 ms).  Design: cluster
// split-K that streams the weights.  The grid is (N/BN column slabs, C K
// ranks), launched as (1, C, 1) clusters, C <= 8 from (K, N) only, so that
// slabs * C comes near 192 CTAs on the 132 SMs.  Each CTA stages its x slice
// in shared memory and streams its slab of K/C weight rows with 16-byte
// non-coherent loads, eight rows a thread a step, each step's loads in flight
// while the previous step's FMAs run (the first while x is staged); every
// weight byte is read once across the grid.  The CTA's warps reduce through
// shared memory in a fixed order, then rank 0 sums the C ranks' partials
// through distributed shared memory in rank order, applies the activation and
// stores: the aggregation stays on chip, in one launch, and the bits are the
// same from run to run.  C and the K order do not depend on M, so row r of an
// M = 4 call equals an M = 1 call on that row.  What the bound leaves out is
// the launch's fixed cost (launch, reduction, cluster syncs), which on the
// H100 is of the order of a decode layer's 1.3-3.8 us of weights (PERF.md).
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
// converts x while staging it; the tf32x3 one lands bf16 tiles (half the
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "gemm_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

// ----------------------------------------------------------------- variant A

constexpr int kSkinnyRows = 8;       // M <= 8: rows of every accumulator
constexpr int kSkinnyThreads = 256;
constexpr int kSkinnyUnroll = 8;     // weight rows a thread a step
constexpr int kSkinnyStage = 1024;   // x rows (of K) staged at a time
constexpr int kMaxCluster = 8;       // the portable cluster size

template <int BN, bool kVec, typename TX, typename TO>
__global__ void __launch_bounds__(kSkinnyThreads, 2)
mm_skinny_kernel(const TX* __restrict__ x, const float* __restrict__ w,
                 TO* __restrict__ out, int m, int k, int n, int act, int kc) {
  constexpr int kQuads = BN / 4;                    // lanes across a weight row
  constexpr int kGroups = kSkinnyThreads / kQuads;  // weight rows a CTA step reads at once
  static_assert(kGroups * kSkinnyRows * BN == kSkinnyStage * kSkinnyRows, "smem reuse");
  // x staged as f32 xs[k][8] (two float4 broadcasts a row), reused after the
  // K loop as the warps' partials red[group][row][BN]
  __shared__ __align__(16) float smem[kSkinnyStage * kSkinnyRows];
  __shared__ __align__(16) float part[kSkinnyRows * BN];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  const int q = tid % kQuads, g = tid / kQuads;
  const int col0 = blockIdx.x * BN;
  const int col = col0 + q * 4;
  const int kbeg = min(k, rank * kc), kend = min(k, kbeg + kc);

  float acc[kSkinnyRows][4];
#pragma unroll
  for (int r = 0; r < kSkinnyRows; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

  // eight weight rows a thread, zero past the rank's K range and past N
  auto load_step = [&](float4 (&wv)[kSkinnyUnroll], int c0, int kb, int rows) {
#pragma unroll
    for (int u = 0; u < kSkinnyUnroll; ++u) {
      const int kr = kb + u * kGroups + g;
      const float* src = w + static_cast<int64_t>(c0 + kr) * n + col;
      wv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (kr < rows) {
        if (kVec) {
          if (col < n) wv[u] = __ldg(reinterpret_cast<const float4*>(src));
        } else {
          if (col < n) wv[u].x = __ldg(src);
          if (col + 1 < n) wv[u].y = __ldg(src + 1);
          if (col + 2 < n) wv[u].z = __ldg(src + 2);
          if (col + 3 < n) wv[u].w = __ldg(src + 3);
        }
      }
    }
  };

  auto fma_step = [&](const float4 (&wv)[kSkinnyUnroll], int kb, int rows) {
    const float4* xs = reinterpret_cast<const float4*>(smem);
#pragma unroll
    for (int u = 0; u < kSkinnyUnroll; ++u) {
      const int kr = kb + u * kGroups + g;
      if (kr >= rows) continue;
      const float4 xa = xs[kr * 2], xb = xs[kr * 2 + 1];
      const float xr[kSkinnyRows] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
      for (int r = 0; r < kSkinnyRows; ++r) {
        acc[r][0] = fmaf(xr[r], wv[u].x, acc[r][0]);
        acc[r][1] = fmaf(xr[r], wv[u].y, acc[r][1]);
        acc[r][2] = fmaf(xr[r], wv[u].z, acc[r][2]);
        acc[r][3] = fmaf(xr[r], wv[u].w, acc[r][3]);
      }
    }
  };

  constexpr int kStep = kGroups * kSkinnyUnroll;  // weight rows a CTA step reads
  for (int c0 = kbeg; c0 < kend; c0 += kSkinnyStage) {
    const int rows = min(kSkinnyStage, kend - c0);
    // two register buffers in turn: one step's loads fly while the other's
    // FMAs run; the first already while x is staged
    float4 wa[kSkinnyUnroll], wb[kSkinnyUnroll];
    load_step(wa, c0, 0, rows);
    __syncthreads();  // the previous chunk's xs reads are done
    for (int i = tid; i < rows * kSkinnyRows; i += kSkinnyThreads) {
      const int r = i / rows, kr = i % rows;
      smem[kr * kSkinnyRows + r] =
          r < m ? octo::to_f32(x[static_cast<int64_t>(r) * k + c0 + kr]) : 0.f;
    }
    __syncthreads();
    for (int kb = 0; kb < rows; kb += 2 * kStep) {
      if (kb + kStep < rows) load_step(wb, c0, kb + kStep, rows);
      fma_step(wa, kb, rows);
      if (kb + kStep >= rows) break;
      if (kb + 2 * kStep < rows) load_step(wa, c0, kb + 2 * kStep, rows);
      fma_step(wb, kb + kStep, rows);
    }
  }

  // the CTA's row groups, summed in group order
  __syncthreads();  // xs is dead: smem becomes red
  float* red = smem;
#pragma unroll
  for (int r = 0; r < kSkinnyRows; ++r)
    *reinterpret_cast<float4*>(&red[(g * kSkinnyRows + r) * BN + q * 4]) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  for (int e = tid; e < m * BN; e += kSkinnyThreads) {
    float s = red[e];
    for (int gg = 1; gg < kGroups; ++gg) s += red[gg * kSkinnyRows * BN + e];
    part[e] = s;
  }
  // the cluster's K ranks, summed in rank order into rank 0 through DSMEM
  cluster.sync();
  if (rank == 0) {
    for (int e = tid; e < m * BN; e += kSkinnyThreads) {
      const int r = e / BN, c = col0 + e % BN;
      if (c >= n) continue;
      float s = part[e];
      for (int rr = 1; rr < ranks; ++rr) s += cluster.map_shared_rank(part, rr)[e];
      octo::put(out + static_cast<int64_t>(r) * n + c, octo::activate(s, act));
    }
  }
  cluster.sync();  // no rank leaves while rank 0 still reads its partials
}

template <int BN, bool kVec, typename TX, typename TO>
cudaError_t launch_skinny(const TX* x, const float* w, TO* out, int m, int k, int n, int act,
                          int split, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + BN - 1) / BN, split, 1);
  cfg.blockDim = dim3(kSkinnyThreads, 1, 1);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int kc = (k + split - 1) / split;
  return cudaLaunchKernelEx(&cfg, mm_skinny_kernel<BN, kVec, TX, TO>, x, w, out, m, k, n, act,
                            kc);
}

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
  if (tile <= 1) {
    const bool vec = n % 4 == 0 && octo::aligned(w, 16);
    if (tile == 0)
      return vec ? launch_skinny<64, true>(x, w, out, m, k, n, act, split, s)
                 : launch_skinny<64, false>(x, w, out, m, k, n, act, split, s);
    return vec ? launch_skinny<128, true>(x, w, out, m, k, n, act, split, s)
               : launch_skinny<128, false>(x, w, out, m, k, n, act, split, s);
  }
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
  if (m <= 0 || n <= 0 || k < 0 || tile < 0 || tile > 4 || skinny != (m <= kSkinnyRows) ||
      split < 1 || split > (skinny ? kMaxCluster : 1) || (m + 31) / 32 > 65535 || !dtypes)
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
