// mm_fused: f32 (M,K) @ (K,N) -> (M,N) with the sum of every output kept on
// chip across K and the activation applied once, in the epilogue.
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
// pipelines' thin K.  Design: a 3xTF32 tensor-core GEMM.  mma.sync m16n8k8
// takes each operand split at fragment load into hi = rna_tf32(v) and lo =
// rna_tf32(v - hi) (cvt.rna's rounding, done in integer ops);
// lo*hi + hi*lo + hi*hi accumulate at every k-step, which holds the f32
// reference's rtol 1e-5 where one tf32 product misses it by some 20x.  The
// tensor cores' own f32 accumulation truncates, so its error grows with every
// step: carried over all of K = 3072 it missed rtol 1e-5 on the H100 (PERF.md).
// So each 32-deep K tile sums from 0 in the tensor cores (12 mma steps) and is
// then promoted into the output's f32 sum with one round-to-nearest add.
// Tiles of 32 x BN x 32 (BN 128, 64 or 32, picked by shape) are fed by a
// 3-stage cp.async ring: 16-byte copies, zero-filled on ragged edges, or
// 4-byte copies of both operands where K, N or a base is not 16-byte aligned
// (the paper's N = 162, the tests' K = 5 and 300).
// The shared tiles are padded so that the A fragments (one ldmatrix each) and
// the transposed B fragment reads (w is (K,N) with N contiguous, but tf32 mma
// takes B only as .col) are free of bank conflicts.  K is never split and its
// order never changes with the tile or M, so a row's result does not depend
// on M either.
//
// Left for later: wgmma (it takes tf32 B only K-major, so the weights would
// need another layout), TMA loads and warp specialisation.
#include <atomic>

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

// ----------------------------------------------------------------- variant A

constexpr int kSkinnyRows = 8;       // M <= 8: rows of every accumulator
constexpr int kSkinnyThreads = 256;
constexpr int kSkinnyUnroll = 8;     // weight rows a thread a step
constexpr int kSkinnyStage = 1024;   // x rows (of K) staged at a time
constexpr int kMaxCluster = 8;       // the portable cluster size

template <int BN, bool kVec>
__global__ void __launch_bounds__(kSkinnyThreads, 2)
mm_skinny_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 float* __restrict__ out, int m, int k, int n, int act, int kc) {
  constexpr int kQuads = BN / 4;                    // lanes across a weight row
  constexpr int kGroups = kSkinnyThreads / kQuads;  // weight rows a CTA step reads at once
  static_assert(kGroups * kSkinnyRows * BN == kSkinnyStage * kSkinnyRows, "smem reuse");
  // x staged as xs[k][8] (two float4 broadcasts a row), reused after the K loop
  // as the warps' partials red[group][row][BN]
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
      smem[kr * kSkinnyRows + r] = r < m ? x[static_cast<int64_t>(r) * k + c0 + kr] : 0.f;
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
      out[static_cast<int64_t>(r) * n + c] = octo::activate(s, act);
    }
  }
  cluster.sync();  // no rank leaves while rank 0 still reads its partials
}

template <int BN, bool kVec>
cudaError_t launch_skinny(const float* x, const float* w, float* out, int m, int k, int n,
                          int act, int split, cudaStream_t stream) {
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
  return cudaLaunchKernelEx(&cfg, mm_skinny_kernel<BN, kVec>, x, w, out, m, k, n, act, kc);
}

// ----------------------------------------------------------------- variant B

constexpr int kBK = 32;      // K tile; the K order of every output
constexpr int kStages = 3;   // cp.async ring depth
constexpr int kAPad = 4;     // As[m][32 + 4]: A fragment reads hit 32 banks
constexpr int kBPad = 8;     // Bs[k][BN + 8]: transposed B reads hit 32 banks

// One cp.async of kBytes (16 or 4) from src into shared memory, or kBytes of
// zeros when `ok` is false (the zero-fill source size).
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(ok ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src),
                 "n"(kBytes), "r"(ok ? kBytes : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// v = hi + lo with both parts tf32, each rounded to nearest with ties away
// from zero as cvt.rna.tf32.f32 rounds, here in two integer ops: add half a
// tf32 ulp to the magnitude bits, drop the low 13
__device__ __forceinline__ uint32_t rna_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(v);
  lo = rna_tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int BM, int BN>
constexpr int tile_smem_bytes() {
  return kStages * (BM * (kBK + kAPad) + kBK * (BN + kBPad)) * 4;
}

// One BM x 32 tile of x and one 32 x BN tile of w into ring stage `as`/`bs`
// in copies of kCopy bytes, zero-filled past M, N and K.  The launcher takes
// 16 bytes only where K and N are multiples of 4 floats and both bases 16-byte
// aligned, so a copy is all in or all out.
template <int BM, int BN, int kThreads, int kCopy>
__device__ __forceinline__ void load_tiles(float* as, float* bs, const float* x, const float* w,
                                           int m, int k, int n, int64_t row0, int col0, int k0,
                                           int tid) {
  constexpr int kAS = kBK + kAPad, kBS = BN + kBPad;
  constexpr int kE = kCopy / 4;  // floats a copy
#pragma unroll 4
  for (int i = tid; i < BM * kBK / kE; i += kThreads) {
    const int r = i / (kBK / kE), c = (i % (kBK / kE)) * kE;
    const int64_t gr = row0 + r;
    const bool ok = gr < m && k0 + c < k;
    cp_async<kCopy>(as + r * kAS + c, ok ? x + gr * k + k0 + c : x, ok);
  }
#pragma unroll 4
  for (int i = tid; i < kBK * BN / kE; i += kThreads) {
    const int r = i / (BN / kE), c = (i % (BN / kE)) * kE;
    const bool ok = k0 + r < k && col0 + c < n;
    cp_async<kCopy>(bs + r * kBS + c, ok ? w + static_cast<int64_t>(k0 + r) * n + col0 + c : w, ok);
  }
}

// BM x BN output tile per CTA; warps of WM x WN, each a grid of m16n8 mma
// tiles; at least kMinBlocks CTAs an SM (the launch bound caps registers).
template <int BM, int BN, int WM, int WN, int kMinBlocks, int kCopy>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32, kMinBlocks)
mm_tf32x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 float* __restrict__ out, int m, int k, int n, int act) {
  constexpr int kThreads = (BM / WM) * (BN / WN) * 32;
  constexpr int kMT = WM / 16, kNT = WN / 8;
  constexpr int kAS = kBK + kAPad, kBS = BN + kBPad;
  constexpr int kStageFloats = BM * kAS + kBK * kBS;
  extern __shared__ __align__(16) float ring[];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;  // the mma fragments' groupID, thread-in-group
  const int wm0 = (warp / (BN / WN)) * WM, wn0 = (warp % (BN / WN)) * WN;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int col0 = blockIdx.x * BN;
  const int tiles = (k + kBK - 1) / kBK;

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) {
      float* as = ring + s * kStageFloats;
      load_tiles<BM, BN, kThreads, kCopy>(as, as + BM * kAS, x, w, m, k, n, row0, col0,
                                             s * kBK, tid);
    }
    cp_async_commit();
  }

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t landed for every thread; stage (t - 1) % S is free
    const int next = t + kStages - 1;
    if (next < tiles) {
      float* as = ring + (next % kStages) * kStageFloats;
      load_tiles<BM, BN, kThreads, kCopy>(as, as + BM * kAS, x, w, m, k, n, row0, col0,
                                             next * kBK, tid);
    }
    cp_async_commit();

    const float* as = ring + (t % kStages) * kStageFloats;
    const float* bs = as + BM * kAS;
    // the tile's 32-deep sum starts from 0 in the tensor cores and is
    // promoted into acc with one round-to-nearest add (see the note)
    float tile[kMT][kNT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) tile[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float* b = bs + (kk + tig) * kBS + wn0 + j * 8 + gid;
        split_tf32(b[0], bh[j][0], bl[j][0]);
        split_tf32(b[4 * kBS], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        // the A fragment (rows gid and gid + 8, columns tig and tig + 4) in one
        // ldmatrix: four 8 x 4 float blocks read as 8 x 8 b16 matrices
        uint32_t ah[4], al[4], raw[4];
        const float* a =
            as + (wm0 + i * 16 + lane % 8 + (lane / 8) % 2 * 8) * kAS + kk + lane / 16 * 4;
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                     : "=r"(raw[0]), "=r"(raw[1]), "=r"(raw[2]), "=r"(raw[3])
                     : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(a))));
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(raw[e]), ah[e], al[e]);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          mma_tf32(tile[i][j], al, bh[j]);
          mma_tf32(tile[i][j], ah, bl[j]);
          mma_tf32(tile[i][j], ah, bh[j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += tile[i][j][e];
  }
  cp_async_wait<0>();

  const bool pairs = (n % 2) == 0;  // then (row, even col) pairs are 8-byte aligned
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t r = row0 + wm0 + i * 16 + gid + h * 8;
      if (r >= m) continue;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int c = col0 + wn0 + j * 8 + tig * 2;
        const float v0 = octo::activate(acc[i][j][h * 2], act);
        const float v1 = octo::activate(acc[i][j][h * 2 + 1], act);
        float* dst = out + r * n + c;
        if (pairs && c + 1 < n) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          if (c < n) dst[0] = v0;
          if (c + 1 < n) dst[1] = v1;
        }
      }
    }
}

// Above 48 KB of shared memory a kernel must opt in, once on each device:
// `done` holds, a bit an ordinal, the devices where the kernel has opted in.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, int bytes, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;  // past 64: every launch
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <int BM, int BN, int WM, int WN, int kMinBlocks, int kCopy>
cudaError_t launch_tf32x3(const float* x, const float* w, float* out, int m, int k, int n,
                          int act, cudaStream_t stream) {
  constexpr int kThreads = (BM / WM) * (BN / WN) * 32;
  constexpr int kSmem = tile_smem_bytes<BM, BN>();
  static_assert(kSmem * kMinBlocks <= 227 * 1024, "ring exceeds the SM's shared memory");
  auto kernel = mm_tf32x3_kernel<BM, BN, WM, WN, kMinBlocks, kCopy>;
  static std::atomic<uint64_t> opted{0};
  const cudaError_t opt_in = opt_in_smem(kernel, kSmem, opted);
  if (opt_in != cudaSuccess) return opt_in;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  kernel<<<grid, kThreads, kSmem, stream>>>(x, w, out, m, k, n, act);
  return cudaSuccess;
}

// BM x BN tiles in 16-byte copies, or in 4-byte ones where `vec` is false;
// warps of WM x WN; the CTAs an SM the launch bound guarantees (registers and
// ring permit them)
template <int BM, int BN, int WM, int WN, int kMinBlocks>
cudaError_t launch_tf32x3_copy(bool vec, const float* x, const float* w, float* out, int m,
                               int k, int n, int act, cudaStream_t s) {
  return vec ? launch_tf32x3<BM, BN, WM, WN, kMinBlocks, 16>(x, w, out, m, k, n, act, s)
             : launch_tf32x3<BM, BN, WM, WN, kMinBlocks, 4>(x, w, out, m, k, n, act, s);
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

}  // namespace

// One launch of the plan's tile, an index into kernels/arype_matmul/ops.py:
// MM_FUSED_TILES (0-1 skinny, 8 rows by 64 or 128 columns; 2-4 tf32x3, 32 rows
// by 128, 64 or 32), split over `split` K ranks.  A plan this file cannot run
// (a tile out of range or of the wrong variant for M, C outside 1..8 or not 1
// for tf32x3, a grid past its limits) is refused with cudaErrorInvalidValue
// and launches nothing.
extern "C" int mm_fused_launch(const void* xp, const void* wp, void* outp, int m, int k, int n,
                               int act, int tile, int split, void* stream) {
  const float* x = static_cast<const float*>(xp);
  const float* w = static_cast<const float*>(wp);
  float* out = static_cast<float*>(outp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool skinny = tile == 0 || tile == 1;
  if (m <= 0 || n <= 0 || k < 0 || tile < 0 || tile > 4 || skinny != (m <= kSkinnyRows) ||
      split < 1 || split > (skinny ? kMaxCluster : 1) || (m + 31) / 32 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (skinny) {
    const bool vec = n % 4 == 0 && aligned(w, 16);
    if (tile == 0)
      err = vec ? launch_skinny<64, true>(x, w, out, m, k, n, act, split, s)
                : launch_skinny<64, false>(x, w, out, m, k, n, act, split, s);
    else
      err = vec ? launch_skinny<128, true>(x, w, out, m, k, n, act, split, s)
                : launch_skinny<128, false>(x, w, out, m, k, n, act, split, s);
  } else {
    const bool vec = k % 4 == 0 && n % 4 == 0 && aligned(x, 16) && aligned(w, 16);
    if (tile == 2) err = launch_tf32x3_copy<32, 128, 32, 32, 3>(vec, x, w, out, m, k, n, act, s);
    if (tile == 3) err = launch_tf32x3_copy<32, 64, 16, 32, 5>(vec, x, w, out, m, k, n, act, s);
    if (tile == 4) err = launch_tf32x3_copy<32, 32, 16, 16, 7>(vec, x, w, out, m, k, n, act, s);
  }
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}
