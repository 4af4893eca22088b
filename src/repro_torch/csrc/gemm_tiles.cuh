// The 32-row tile skeleton of the port's tensor-core GEMMs: mm_fused's tf32x3
// variant (mm_fused.cu), the unfused ablation's partials (mm_unfused_partials.cu)
// and the int8 mm_fused_q (mm_fused_q.cu).
//
// Each CTA computes a BM x BN output tile (BM = 32; BN 128, 64 or 32, picked
// by shape in kernels/arype_matmul/ops.py:gemm_tile) in warps of WM x WN:
// four for the tf32x3 tiles (with_tile), eight for the int8 ones
// (mm_fused_q.cu).  The operands come in 32-deep K tiles through a 3-stage
// ring: w (f32) and x (f32, or bf16 for mm_fused's mixed arm) each in 16-byte
// cp.async copies where the launcher finds its rows and base 16-byte aligned,
// else 4-byte ones; a bf16 x with odd K or a 2-byte-aligned base has no
// cp.async copy at all (they move 4, 8 or 16 bytes), so its tiles load
// synchronously, element by element.  Every copy is zero-filled past M, N
// and the K range's end.  A bf16 x tile lands as bf16, in its own row
// stride, in the stage's A region.
//
// tf32x3_sum is the 3xTF32 mainloop over one K range [kbeg, kend): mma.sync
// m16n8k8 on each operand split into hi = rna_tf32(v) and lo = rna_tf32(v - hi),
// lo*hi + hi*lo + hi*hi at every k-step, which holds the f32 reference's rtol
// 1e-5 where one tf32 product misses it by some 20x.  A bf16 value is a tf32
// value (8 significand bits fit in 10): its split is hi = its bits << 16 and
// lo = 0, so the bf16 arm drops the lo*hi product and issues the other two,
// in the same order, on the same values as the f32 arm on x.float(): the two
// arms give the same bits.  The tensor cores' own
// f32 accumulation truncates, so each 32-deep K tile sums from 0 (12 mma steps)
// and is then promoted into the caller's f32 sum with one round-to-nearest
// add.  mm_fused runs it over all of K; the partials kernel over its block.
// The tiles start at kbeg and their order never changes with the tile or M,
// so a partial of a 32-deep block is exactly the fused kernel's promoted tile.
#pragma once

#include <atomic>

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace octo {

constexpr int kBK = 32;      // K tile; the K order of every output
constexpr int kStages = 3;   // cp.async ring depth
constexpr int kAPad = 4;     // As[m][32 + 4]: A fragment reads hit 32 banks
constexpr int kBPad = 8;     // Bs[k][BN + 8]: transposed B reads hit 32 banks
// A bf16 A tile's row stride, As[m][32 + 8] of 80 bytes: 16-byte copies stay
// aligned, and the fragment's eight rows start 20 words apart, so its
// 16-bit reads (two lanes a word) hit distinct banks
constexpr int kAStrideBf16 = kBK + 8;

// An A tile's row stride in elements of TA; the stage's A region holds
// BM * (kBK + kAPad) floats whatever TA is, so B sits at the same offset.
template <typename TA>
__host__ __device__ constexpr int a_stride() {
  return sizeof(TA) == 4 ? kBK + kAPad : kAStrideBf16;
}

template <int BM, int BN>
__host__ __device__ constexpr int ring_floats() {
  return kStages * (BM * (kBK + kAPad) + kBK * (BN + kBPad));
}

// One copy of kBytes from src into shared memory, or kBytes of zeros when
// `ok` is false: a cp.async of 16 or 4 bytes (the zero-fill source size), or,
// for kBytes == sizeof(T) == 2, a synchronous load and store.
template <int kBytes, typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool ok) {
  if constexpr (kBytes == 2) {
    static_assert(sizeof(T) == 2, "a 2-byte copy moves one bf16");
    *dst = ok ? *src : T(0);
  } else {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    if constexpr (kBytes == 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                   "r"(ok ? 16 : 0));
    } else {
      static_assert(kBytes == 4, "cp.async copies of 16 or 4 bytes");
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src),
                   "n"(kBytes), "r"(ok ? kBytes : 0));
    }
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One BM x 32 tile of x and one 32 x BN tile of w into ring stage `as`/`bs`
// in copies of kCopyX and kCopyW bytes, zero-filled past M, N and kend.  x is
// (M, K) of TA (f32 or bf16 bits) with row stride k.  The launcher takes
// 16-byte copies of x only where k and kend's block are multiples of 16
// bytes and x's base 16-byte aligned, 4-byte ones only where they are
// multiples of 4 bytes and the base 4-byte aligned (else, bf16 only, 2-byte
// synchronous loads), of w 16-byte ones only where N is and w's base is, so
// a copy is all in or all out.  A thread's copies of a tile share one column
// and step down the rows, so its addresses and its column mask are computed
// once a tile.
template <int BM, int BN, int kThreads, int kCopyX, int kCopyW, typename TA>
__device__ __forceinline__ void load_tiles(TA* as, float* bs, const TA* x, const float* w,
                                           int m, int k, int kend, int n, int64_t row0,
                                           int col0, int k0, int tid) {
  constexpr int kAS = a_stride<TA>(), kBS = BN + kBPad;
  constexpr int kAE = kCopyX / sizeof(TA), kBE = kCopyW / 4;  // elements a copy
  constexpr int kAC = kBK / kAE, kBC = BN / kBE;      // copies across a row of each tile
  constexpr int kAR = kThreads / kAC, kBR = kThreads / kBC;  // rows a step of the CTA
  static_assert(kAE >= 1 && kCopyX % sizeof(TA) == 0, "a copy moves whole elements");
  static_assert(kThreads % kAC == 0 && kThreads % kBC == 0, "a thread keeps its column");
  static_assert(BM % kAR == 0 && kBK % kBR == 0, "the CTA's steps cover every row of a tile");
  {
    const int r = tid / kAC, c = tid % kAC * kAE;
    const bool in_k = k0 + c < kend;
    const TA* src = x + (row0 + r) * k + k0 + c;
#pragma unroll
    for (int j = 0; j < BM / kAR; ++j) {
      const bool ok = in_k && row0 + r + j * kAR < m;
      cp_async<kCopyX>(as + (r + j * kAR) * kAS + c, ok ? src + int64_t{j} * kAR * k : x, ok);
    }
  }
  {
    const int r = tid / kBC, c = tid % kBC * kBE;
    const bool in_n = col0 + c < n;
    const float* src = w + static_cast<int64_t>(k0 + r) * n + col0 + c;
#pragma unroll
    for (int j = 0; j < kBK / kBR; ++j) {
      const bool ok = in_n && k0 + r + j * kBR < kend;
      cp_async<kCopyW>(bs + (r + j * kBR) * kBS + c, ok ? src + int64_t{j} * kBR * n : w, ok);
    }
  }
}

// The ring over the 32-deep K tiles of [kbeg, kend): fills the first
// kStages - 1 stages, then for every tile waits for it to land, issues the
// loads kStages - 1 tiles ahead and calls body(as, bs) on the landed stage
// (`as` the stage's A region, of TA in a_stride<TA>() rows).  The wait's
// __syncthreads also guards whatever body wrote in shared memory for the
// previous tile, and makes a tile that loaded synchronously visible.
template <int BM, int BN, int kThreads, int kCopyX, int kCopyW, typename TA, typename Body>
__device__ __forceinline__ void ring_loop(float* ring, const TA* x, const float* w, int m,
                                          int k, int n, int64_t row0, int col0, int kbeg,
                                          int kend, Body body) {
  constexpr int kAF = kBK + kAPad;  // floats a row of the stage's A region
  constexpr int kStageFloats = ring_floats<BM, BN>() / kStages;
  const int tid = threadIdx.x;
  const int tiles = (kend - kbeg + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) {
      float* as = ring + s * kStageFloats;
      load_tiles<BM, BN, kThreads, kCopyX, kCopyW>(reinterpret_cast<TA*>(as), as + BM * kAF,
                                                   x, w, m, k, kend, n, row0, col0,
                                                   kbeg + s * kBK, tid);
    }
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t landed for every thread; stage (t - 1) % S is free
    const int next = t + kStages - 1;
    if (next < tiles) {
      float* as = ring + (next % kStages) * kStageFloats;
      load_tiles<BM, BN, kThreads, kCopyX, kCopyW>(reinterpret_cast<TA*>(as), as + BM * kAF,
                                                   x, w, m, k, kend, n, row0, col0,
                                                   kbeg + next * kBK, tid);
    }
    cp_async_commit();
    const float* as = ring + (t % kStages) * kStageFloats;
    body(as, as + BM * kAF);
  }
  cp_async_wait<0>();
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

// acc += x[rows, kbeg:kend) @ w[kbeg:kend, cols) for this CTA's BM x BN tile,
// in 32-deep K tiles from kbeg, each tile's 3xTF32 sum promoted into acc.
// acc is the warp's WM x WN part in m16n8 fragments.  x is f32 or bf16 bits
// (TA); with bf16 the lo*hi product, all zeros, is not issued.
template <int BM, int BN, int WM, int WN, int kCopyX, int kCopyW, typename TA>
__device__ __forceinline__ void tf32x3_sum(float* ring, const TA* x, const float* w, int m,
                                           int k, int n, int64_t row0, int col0, int kbeg,
                                           int kend, float (&acc)[WM / 16][WN / 8][4]) {
  constexpr int kThreads = (BM / WM) * (BN / WN) * 32;
  constexpr int kMT = WM / 16, kNT = WN / 8;
  constexpr int kAS = a_stride<TA>(), kBS = BN + kBPad;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane / 4, tig = lane % 4;  // the mma fragments' groupID, thread-in-group
  const int wm0 = (warp / (BN / WN)) * WM, wn0 = (warp % (BN / WN)) * WN;

  ring_loop<BM, BN, kThreads, kCopyX, kCopyW>(ring, x, w, m, k, n, row0, col0, kbeg, kend,
                                              [&](const float* as, const float* bs) {
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
        uint32_t ah[4];
        if constexpr (sizeof(TA) == 2) {
          // the A fragment (rows gid and gid + 8, columns tig and tig + 4):
          // four 16-bit reads, each bf16's bits the top half of its tf32 hi;
          // its lo is 0, so lo*hi adds nothing and is skipped
          const bf16_bits* a =
              reinterpret_cast<const bf16_bits*>(as) + (wm0 + i * 16 + gid) * kAS + kk + tig;
          ah[0] = static_cast<uint32_t>(a[0]) << 16;
          ah[1] = static_cast<uint32_t>(a[8 * kAS]) << 16;
          ah[2] = static_cast<uint32_t>(a[4]) << 16;
          ah[3] = static_cast<uint32_t>(a[8 * kAS + 4]) << 16;
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            mma_tf32(tile[i][j], ah, bl[j]);
            mma_tf32(tile[i][j], ah, bh[j]);
          }
        } else {
          // the same fragment in one ldmatrix: four 8 x 4 float blocks read
          // as 8 x 8 b16 matrices
          uint32_t al[4], raw[4];
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
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += tile[i][j][e];
  });
}

// Stores the warp's m16n8 fragments of the CTA's tile into the (M, N) `out`
// (f32, or bf16 rounded once, to nearest even), each value through value(v,
// j, p) (j the warp's n8 fragment, p the column's parity in it); (row, even
// col) pairs as one 8- or 4-byte store where N is even.  The fragments'
// layout is that of both mma.sync shapes used here (m16n8k8 f32, m16n8k32
// s32).
template <int BM, int BN, int WM, int WN, typename TO, typename T, typename Value>
__device__ __forceinline__ void store_tile(TO* out, const T (&acc)[WM / 16][WN / 8][4], int m,
                                           int n, int64_t row0, int col0, Value value) {
  constexpr int kMT = WM / 16, kNT = WN / 8;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wm0 = (warp / (BN / WN)) * WM, wn0 = (warp % (BN / WN)) * WN;
  const bool pairs = (n % 2) == 0;  // then (row, even col) pairs are aligned
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t r = row0 + wm0 + i * 16 + gid + h * 8;
      if (r >= m) continue;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int c = col0 + wn0 + j * 8 + tig * 2;
        TO* dst = out + r * n + c;
        if (pairs && c + 1 < n) {
          put2(dst, value(acc[i][j][h * 2], j, 0), value(acc[i][j][h * 2 + 1], j, 1));
        } else {
          if (c < n) put(dst, value(acc[i][j][h * 2], j, 0));
          if (c + 1 < n) put(dst + 1, value(acc[i][j][h * 2 + 1], j, 1));
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

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The tiles of kernels/arype_matmul/ops.py:TF32X3_TILES by index (32 rows by
// 128, 64 or 32 columns), each with the tf32x3 variant's warp shape and the
// CTAs an SM its launch bound asks for: f(Tile<BM, BN, WM, WN, kMinBlocks>{})
// for tile 0, 1 or 2; cudaErrorInvalidValue for any other index.  The one
// place on the C side that lists the tiles' (BM, BN): mm_fused_q.cu derives
// its warps from them.
template <int BM_, int BN_, int WM_, int WN_, int kMinBlocks_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, kMinBlocks = kMinBlocks_;
  static constexpr int kThreads = (BM / WM) * (BN / WN) * 32;
};

// f(Copies<kX, kW>{}): copies of kX bytes of x (16 or 4, or 2 for a bf16 x's
// synchronous loads; copy_width picks it) and 16-byte copies of w where vec_w,
// else 4-byte ones.
template <int kX, int kW>
struct Copies {
  static constexpr int X = kX, W = kW;
};

template <typename TA, typename F>
cudaError_t with_copies(int copy_x, bool vec_w, F f) {
  switch (copy_x) {
    case 16:
      return vec_w ? f(Copies<16, 16>{}) : f(Copies<16, 4>{});
    case 4:
      return vec_w ? f(Copies<4, 16>{}) : f(Copies<4, 4>{});
    case 2:
      if constexpr (sizeof(TA) == 2) return vec_w ? f(Copies<2, 16>{}) : f(Copies<2, 4>{});
      else return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

// The widest copy of an (M, K) operand of `elem`-byte elements at `p` that
// keeps every copy of a row inside it: 16 bytes where the rows and the base
// are 16-byte aligned, else 4 where they are 4-byte aligned, else one
// element (bf16 only: an f32 operand is always 4-byte aligned).
inline int copy_width(const void* p, int k, int elem) {
  const int64_t row = int64_t{k} * elem;
  if (row % 16 == 0 && aligned(p, 16)) return 16;
  if (row % 4 == 0 && aligned(p, 4)) return 4;
  return elem;
}

template <typename F>
cudaError_t with_tile(int tile, F f) {
  switch (tile) {
    case 0:
      return f(Tile<32, 128, 32, 32, 3>{});
    case 1:
      return f(Tile<32, 64, 16, 32, 5>{});
    case 2:
      return f(Tile<32, 32, 16, 16, 7>{});
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace octo
