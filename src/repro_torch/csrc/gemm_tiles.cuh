// The 32-row tile skeleton of the port's tensor-core GEMMs: mm_fused's tf32x3
// variant (mm_fused.cu), the unfused ablation's partials (mm_unfused_partials.cu)
// and the int8 mm_fused_q (mm_fused_q.cu).
//
// Each CTA computes a BM x BN output tile (BM = 32; BN 128, 64 or 32, picked
// by shape in kernels/arype_matmul/ops.py:gemm_tile) in warps of WM x WN:
// four for the tf32x3 tiles (with_tile), eight for the int8 ones
// (mm_fused_q.cu).  The operands come in 32-deep K tiles through a 3-stage
// ring: x and w, each f32 or bf16, in 16-byte cp.async copies where the
// launcher finds the operand's rows and base 16-byte aligned, else in 4-byte
// ones (f32 either operand, bf16 x); a bf16 x with odd K or a 2-byte-aligned
// base, and a bf16 w whose rows or base are not 16-byte aligned, take no
// cp.async copy (they move 4, 8 or 16 bytes): their tiles load synchronously,
// element by element.  Every copy is zero-filled past M, N and the K range's
// end.  A bf16 tile lands as bf16, in its own row stride, in its operand's
// region of the stage (which is sized for f32, so the regions sit at the same
// offsets whatever the types).
//
// tf32x3_sum is the 3xTF32 mainloop over one K range [kbeg, kend): mma.sync
// m16n8k8 on each operand split into hi = rna_tf32(v) and lo = rna_tf32(v - hi),
// lo*hi + hi*lo + hi*hi at every k-step, which holds the f32 reference's rtol
// 1e-5 where one tf32 product misses it by some 20x.  A bf16 value is a tf32
// value (8 significand bits fit in 10): its split is hi = its bits << 16 and
// lo = 0, so a product with a bf16 operand's lo adds nothing and is not
// issued.  The others run in the same order, on the same values, as the f32
// arm on the operands' f32 values: every pair of types gives the f32 arm's
// bits on x.float(), w.float().  Three mma.sync a step for f32 x f32, two
// where one operand is bf16, one for bf16 x bf16 (which runs here only where
// TMA cannot load its operands; elsewhere mm_fused_wgmma.cu, in another K
// order).  The tensor cores' own
// f32 accumulation truncates, so each 32-deep K tile sums from 0 (12 mma steps)
// and is then promoted into the caller's f32 sum with one round-to-nearest
// add.  mm_fused runs it over all of K; the partials kernel over its block.
// The tiles start at kbeg and their order never changes with the tile, M or
// the types, so a partial of a 32-deep block is exactly the fused kernel's
// promoted tile.
#pragma once

#include <atomic>

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace octo {

constexpr int kBK = 32;      // K tile; the K order of every output
constexpr int kStages = 3;   // cp.async ring depth
constexpr int kAPad = 4;     // As[m][32 + 4]: A fragment reads hit 32 banks
// Bs[k][BN + 8] in elements of w's type.  f32: the transposed B fragment's
// four k rows start 8 banks apart, so its reads hit 32 banks.  bf16: they
// start BN / 2 + 4 words apart (4 mod 32 at BN 64 and 128, 20 at 32), and
// two lanes of adjacent columns share a word: 16 distinct banks' words
constexpr int kBPad = 8;
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

// The rows x cols tile at `src` (row stride `ld` elements of T) into `dst`
// (row stride kDS) in copies of kCopy bytes, zero-filled where a row is past
// `rows_left` or a copy's first element is past `cols_left`.  The launcher
// takes a copy width only where the operand's rows and base allow it, so a
// copy is all in or all out.  A thread's copies of a tile share one column
// and step down the rows, so its addresses and its column mask are computed
// once a tile; where the CTA has more threads than the tile has copies, the
// threads past them copy nothing.
template <int kRows, int kCols, int kDS, int kThreads, int kCopy, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, const T* any, int64_t ld,
                                          int rows_left, int cols_left, int tid) {
  constexpr int kE = kCopy / sizeof(T);  // elements a copy
  constexpr int kC = kCols / kE;         // copies across a row
  constexpr int kR = kThreads / kC;      // rows a step of the CTA
  static_assert(kE >= 1 && kCopy % sizeof(T) == 0, "a copy moves whole elements");
  static_assert(kThreads % kC == 0, "a thread keeps its column");
  static_assert(kR >= kRows ? true : kRows % kR == 0, "the CTA's steps cover every row");
  const int r = tid / kC, c = tid % kC * kE;
  if (kR > kRows && r >= kRows) return;
  const bool in_c = c < cols_left;
  const T* s = src + r * ld + c;
#pragma unroll
  for (int j = 0; j < (kR >= kRows ? 1 : kRows / kR); ++j) {
    const bool ok = in_c && r + j * kR < rows_left;
    cp_async<kCopy>(dst + (r + j * kR) * kDS + c, ok ? s + int64_t{j} * kR * ld : any, ok);
  }
}

// One BM x 32 tile of x and one 32 x BN tile of w into ring stage `as`/`bs`
// in copies of kCopyX and kCopyW bytes, zero-filled past M, N and kend.  x is
// (M, K) of TA with row stride k, w (K, N) of TW with row stride n (TA and TW
// f32 or bf16 bits).
template <int BM, int BN, int kThreads, int kCopyX, int kCopyW, typename TA, typename TW>
__device__ __forceinline__ void load_tiles(TA* as, TW* bs, const TA* x, const TW* w, int m,
                                           int k, int kend, int n, int64_t row0, int col0,
                                           int k0, int tid) {
  const int64_t rows = m - row0;  // past BM, every row of the tile is in
  load_tile<BM, kBK, a_stride<TA>(), kThreads, kCopyX>(
      as, x + row0 * k + k0, x, k, rows < BM ? static_cast<int>(rows) : BM, kend - k0, tid);
  load_tile<kBK, BN, BN + kBPad, kThreads, kCopyW>(
      bs, w + static_cast<int64_t>(k0) * n + col0, w, n, kend - k0, n - col0, tid);
}

// The ring over the 32-deep K tiles of [kbeg, kend): fills the first
// kStages - 1 stages, then for every tile waits for it to land, issues the
// loads kStages - 1 tiles ahead and calls body(as, bs) on the landed stage
// (`as` the stage's A region, of TA in a_stride<TA>() rows; `bs` its B
// region, of TW in rows of BN + kBPad).  The wait's __syncthreads also
// guards whatever body wrote in shared memory for the previous tile, and
// makes a tile that loaded synchronously visible.
template <int BM, int BN, int kThreads, int kCopyX, int kCopyW, typename TA, typename TW,
          typename Body>
__device__ __forceinline__ void ring_loop(float* ring, const TA* x, const TW* w, int m, int k,
                                          int n, int64_t row0, int col0, int kbeg, int kend,
                                          Body body) {
  constexpr int kAF = kBK + kAPad;  // floats a row of the stage's A region
  constexpr int kStageFloats = ring_floats<BM, BN>() / kStages;
  const int tid = threadIdx.x;
  const int tiles = (kend - kbeg + kBK - 1) / kBK;
  auto load = [&](int t) {
    float* as = ring + (t % kStages) * kStageFloats;
    load_tiles<BM, BN, kThreads, kCopyX, kCopyW>(reinterpret_cast<TA*>(as),
                                                 reinterpret_cast<TW*>(as + BM * kAF), x, w,
                                                 m, k, kend, n, row0, col0, kbeg + t * kBK, tid);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) load(s);
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t landed for every thread; stage (t - 1) % S is free
    if (t + kStages - 1 < tiles) load(t + kStages - 1);
    cp_async_commit();
    const float* as = ring + (t % kStages) * kStageFloats;
    body(reinterpret_cast<const TA*>(as), reinterpret_cast<const TW*>(as + BM * kAF));
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

// A loaded element's tf32 hi, and its lo where it has one: a bf16's hi is
// its bits << 16 and its lo 0 (never read: the product is not issued)
__device__ __forceinline__ void split_tf32(bf16_bits v, uint32_t& hi, uint32_t&) {
  hi = static_cast<uint32_t>(v) << 16;
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += x[rows, kbeg:kend) @ w[kbeg:kend, cols) for this CTA's BM x BN tile,
// in 32-deep K tiles from kbeg, each tile's 3xTF32 sum promoted into acc.
// acc is the warp's WM x WN part in m16n8 fragments.  x (TA) and w (TW) are
// f32 or bf16 bits; a product with a bf16 operand's lo, all zeros, is not
// issued.
template <int BM, int BN, int WM, int WN, int kCopyX, int kCopyW, typename TA, typename TW>
__device__ __forceinline__ void tf32x3_sum(float* ring, const TA* x, const TW* w, int m, int k,
                                           int n, int64_t row0, int col0, int kbeg, int kend,
                                           float (&acc)[WM / 16][WN / 8][4]) {
  constexpr int kThreads = (BM / WM) * (BN / WN) * 32;
  constexpr int kMT = WM / 16, kNT = WN / 8;
  constexpr int kAS = a_stride<TA>(), kBS = BN + kBPad;
  constexpr bool kLoA = sizeof(TA) == 4, kLoB = sizeof(TW) == 4;  // the operands with a lo
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane / 4, tig = lane % 4;  // the mma fragments' groupID, thread-in-group
  const int wm0 = (warp / (BN / WN)) * WM, wn0 = (warp % (BN / WN)) * WN;

  ring_loop<BM, BN, kThreads, kCopyX, kCopyW>(ring, x, w, m, k, n, row0, col0, kbeg, kend,
                                              [&](const TA* as, const TW* bs) {
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
      // the B fragment (k rows tig and tig + 4, column gid), transposed reads
      uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const TW* b = bs + (kk + tig) * kBS + wn0 + j * 8 + gid;
        split_tf32(b[0], bh[j][0], bl[j][0]);
        split_tf32(b[4 * kBS], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        // the A fragment: rows gid and gid + 8, columns tig and tig + 4
        uint32_t ah[4], al[4];
        if constexpr (kLoA) {
          // in one ldmatrix: four 8 x 4 float blocks read as 8 x 8 b16 matrices
          uint32_t raw[4];
          const float* a =
              as + (wm0 + i * 16 + lane % 8 + (lane / 8) % 2 * 8) * kAS + kk + lane / 16 * 4;
          asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                       : "=r"(raw[0]), "=r"(raw[1]), "=r"(raw[2]), "=r"(raw[3])
                       : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(a))));
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(raw[e]), ah[e], al[e]);
        } else {
          // four 16-bit reads, each bf16's bits the top half of its tf32 hi
          const TA* a = as + (wm0 + i * 16 + gid) * kAS + kk + tig;
          split_tf32(a[0], ah[0], al[0]);
          split_tf32(a[8 * kAS], ah[1], al[1]);
          split_tf32(a[4], ah[2], al[2]);
          split_tf32(a[8 * kAS + 4], ah[3], al[3]);
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          if constexpr (kLoA) mma_tf32(tile[i][j], al, bh[j]);
          if constexpr (kLoB) mma_tf32(tile[i][j], ah, bl[j]);
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

// store_tile into `out` of the dtype code out_dtype (kF32 or kBF16; the
// launcher has checked it), a branch that is the same for the whole grid.
// The kernels take the output's type at run time rather than as a template
// argument: each (x, w) pair of types, copy widths and tile is then one
// kernel, not two.
template <int BM, int BN, int WM, int WN, typename T, typename Value>
__device__ __forceinline__ void store_tile_as(void* out, int out_dtype,
                                              const T (&acc)[WM / 16][WN / 8][4], int m, int n,
                                              int64_t row0, int col0, Value value) {
  if (out_dtype == kBF16)
    store_tile<BM, BN, WM, WN>(static_cast<__nv_bfloat16*>(out), acc, m, n, row0, col0, value);
  else
    store_tile<BM, BN, WM, WN>(static_cast<float*>(out), acc, m, n, row0, col0, value);
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

// f(Copies<kX, kW>{}): copies of kX bytes of x and kW bytes of w, each 16 or
// 4, or 2 for a bf16 operand's synchronous loads (copy_width and
// w_copy_width pick them); another width, or 2 for an f32 operand or 4 for
// a bf16 w, is refused with cudaErrorInvalidValue.
template <int kX, int kW>
struct Copies {
  static constexpr int X = kX, W = kW;
};

template <typename TA, typename TW, typename F>
cudaError_t with_copies(int copy_x, int copy_w, F f) {
  auto with_w = [&](auto cx) -> cudaError_t {
    constexpr int X = decltype(cx)::X;
    switch (copy_w) {
      case 16:
        return f(Copies<X, 16>{});
      case 4:
        if constexpr (sizeof(TW) == 4) return f(Copies<X, 4>{});
        else return cudaErrorInvalidValue;
      case 2:
        if constexpr (sizeof(TW) == 2) return f(Copies<X, 2>{});
        else return cudaErrorInvalidValue;
      default:
        return cudaErrorInvalidValue;
    }
  };
  switch (copy_x) {
    case 16:
      return with_w(Copies<16, 0>{});
    case 4:
      return with_w(Copies<4, 0>{});
    case 2:
      if constexpr (sizeof(TA) == 2) return with_w(Copies<2, 0>{});
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

// The copy of a (K, N) weight of `elem`-byte elements at `p`: 16 bytes where
// its rows and base are 16-byte aligned, else 4 for f32 and one element for
// bf16 (the rows of every served bf16 weight are 16-byte aligned: a 4-byte
// bf16 copy would add tiles to the build and run on no path).
inline int w_copy_width(const void* p, int n, int elem) {
  if (int64_t{n} * elem % 16 == 0 && aligned(p, 16)) return 16;
  return elem == 4 ? 4 : 2;
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
