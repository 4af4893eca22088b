// mm_fused_q: int8 blocked (M,K) @ (K,N) with an int32 accumulator kept on
// chip across K, and the per-channel dequant and the activation in the
// epilogue, from f32 or bf16 operands into an f32 or bf16 output, in one
// launch.
//
// Replaces src/repro/kernels/arype_matmul/arype_matmul.py:mm_fused_q (body
// _mm_fused_q_kernel, whose int32 acc_ref stays in VMEM across the K grid
// axis) together with the quantize, pad and slice ops its wrapper
// (ops.py:arype_matmul_q) runs around it.
//
// Bound: at the pipelines' shapes (K 16-128, a few million int8 operations,
// 2MKN over 1979 TOP/s is some 0.01 us) the bytes, and in practice the
// launch, the latency of the first tile's loads and the divisions of the
// quantize pass.  The earlier SIMT design walked K in unpipelined 32-deep steps
// whose scalar loads waited on an IEEE division after every four, so each K
// step cost one load latency; and it ran __dp4a, not the tensor cores.
//
// Design: the 32-row tile skeleton of mm_fused's tf32x3 variant
// (gemm_tiles.cuh), on the int8 tensor cores.  The x and w tiles come
// through the 3-stage cp.async ring in their own types (16-byte copies, or
// the narrower ones gemm_tiles.cuh names for an operand whose rows or base
// are not 16-byte aligned; zero-filled past M, N and K), so all of a tile's
// loads are in flight before any division.  After
// the wait one pass of the CTA turns the landed tile into int8 codes in
// shared memory with octo::quantize_code (IEEE division, rint, clip to
// +-127; a bf16 element is divided as its exact f32, as the reference's
// quantize_i8 divides v.astype(f32)), each element once per CTA: x's codes
// row-major [row][k], four k a
// 32-bit word; w's transposed [n][k], so that a .col B fragment register is 4
// consecutive k bytes.  Each division is a short serial chain ending in a
// range check and a branch, so a thread's divisions do not overlap: the CTA
// runs eight warps, twice mm_fused's four, to halve each thread's chain, and
// a zero (the padding past M, N and K, half of a post-ReLU input), which the
// range check would send down the slow path, takes code 0 directly.  Both
// code rows are 48 bytes (32 + 16 of padding): the fragment reads, ldmatrix
// for A and 32-bit loads for B, then hit 32 distinct banks.  The products run
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32, one per 16 x 8 fragment per K
// tile.  An int32 sum is exact in any order, so the result equals the plain
// twin (kernels/vpe_smallmm/ops.py:vpe_mm_q) bit for bit under none/relu.
// Zero f32 past the edges gives zero codes, which add nothing.  The epilogue
// writes (float)acc * (scale_x * scale_w[n]) through the activation, rounded
// once to the output's type (out_dtype or x.dtype in the reference's
// wrapper, arype_matmul.py:141), the dequant row read before the mainloop so
// its latency hides under the loads.
//
// Left for later: wgmma, TMA, and quantizing the weights once (the reference
// quantizes w on every call too).
#include <atomic>

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "gemm_tiles.cuh"

namespace {

constexpr int kCodeWords = 12;  // a code row: 32 int8 codes + 16 bytes of padding

// The code of v on a positive scale s: octo::quantize_code, except that a
// zero takes code 0 without the division.  IEEE division sends a zero
// dividend down its slow path (FCHK), which serialises the warp; zeros are
// the padding past M, N and K and half of a post-ReLU input.  0 / s rounds
// and clips to 0 for every positive s, so the code is the same.
__device__ __forceinline__ int code(float v, float s) {
  return v == 0.f ? 0 : octo::quantize_code(v, s);
}

// Four int8 codes in one word, the first (lowest k) in the low byte.
__device__ __forceinline__ uint32_t pack4(int c0, int c1, int c2, int c3) {
  return (static_cast<uint32_t>(c0) & 0xffu) | ((static_cast<uint32_t>(c1) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c2) & 0xffu) << 16) | ((static_cast<uint32_t>(c3) & 0xffu) << 24);
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int BM, int BN>
constexpr int smem_bytes() {
  return octo::ring_floats<BM, BN>() * 4 + (BM + BN) * kCodeWords * 4;
}

// Four landed x values of one A tile row at `a` as f32: one 16-byte read of
// f32, one 8-byte read of bf16
__device__ __forceinline__ float4 read4(const float* a) {
  return *reinterpret_cast<const float4*>(a);
}
__device__ __forceinline__ float4 read4(const octo::bf16_bits* a) {
  const uint2 u = *reinterpret_cast<const uint2*>(a);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xFFFF0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xFFFF0000u));
}

template <int BM, int BN, int WM, int WN, int kMinBlocks, int kCopyX, int kCopyW, typename TA,
          typename TW>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32, kMinBlocks)
mm_fused_q_kernel(const TA* __restrict__ x, const TW* __restrict__ w, float scale_x,
                  const float* __restrict__ scale_w, void* __restrict__ out, int out_dtype,
                  int m, int k, int n, int act) {
  constexpr int kThreads = (BM / WM) * (BN / WN) * 32;
  constexpr int kMT = WM / 16, kNT = WN / 8;
  constexpr int kAS = octo::a_stride<TA>(), kBS = BN + octo::kBPad;
  static_assert(kThreads % BN == 0, "a thread quantizes one w column");
  extern __shared__ __align__(16) float ring[];
  uint32_t* aq = reinterpret_cast<uint32_t*>(ring + octo::ring_floats<BM, BN>());  // [BM][12]
  uint32_t* bq = aq + BM * kCodeWords;                                               // [BN][12]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;  // the mma fragments' groupID, thread-in-group
  const int wm0 = (warp / (BN / WN)) * WM, wn0 = (warp % (BN / WN)) * WN;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int col0 = blockIdx.x * BN;
  const int nb = tid % BN;  // the w column this thread quantizes, at every K tile
  const float sw = col0 + nb < n ? scale_w[col0 + nb] : 1.f;
  // the dequant of the columns this thread stores, read while the first
  // tiles load: scale_x * scale_w[c], one f32 product as the twin's row
  float dq[kNT][2];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int c = col0 + wn0 + j * 8 + tig * 2 + p;
      dq[j][p] = c < n ? scale_x * scale_w[c] : 0.f;
    }

  int acc[kMT][kNT][4] = {};
  octo::ring_loop<BM, BN, kThreads, kCopyX, kCopyW>(ring, x, w, m, k, n, row0, col0, 0, k,
                                                    [&](const TA* as, const TW* bs) {
    // the landed tile to int8 codes, each element once
    for (int i = tid; i < BM * octo::kBK / 4; i += kThreads) {
      const int r = i / (octo::kBK / 4), q = i % (octo::kBK / 4);
      const float4 v = read4(as + r * kAS + q * 4);
      aq[r * kCodeWords + q] =
          pack4(code(v.x, scale_x), code(v.y, scale_x), code(v.z, scale_x), code(v.w, scale_x));
    }
    for (int q = tid / BN; q < octo::kBK / 4; q += kThreads / BN) {
      const TW* b = bs + q * 4 * kBS + nb;
      bq[nb * kCodeWords + q] =
          pack4(code(octo::to_f32(b[0]), sw), code(octo::to_f32(b[kBS]), sw),
                code(octo::to_f32(b[2 * kBS]), sw), code(octo::to_f32(b[3 * kBS]), sw));
    }
    __syncthreads();
    // one m16n8k32 product a fragment: B (k rows tig*4.., 16 + tig*4.. of
    // column gid) as two words of the transposed codes
    uint32_t b[kNT][2];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const uint32_t* col = bq + (wn0 + j * 8 + gid) * kCodeWords;
      b[j][0] = col[tig];
      b[j][1] = col[4 + tig];
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      // the A fragment (rows gid and gid + 8, k bytes tig*4.. and 16 + tig*4..)
      // in one ldmatrix: four 8-row x 16-byte blocks read as 8 x 8 b16 matrices
      uint32_t a[4];
      const uint32_t* src =
          aq + (wm0 + i * 16 + lane % 8 + (lane / 8) % 2 * 8) * kCodeWords + lane / 16 * 4;
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                   : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
                   : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(src))));
#pragma unroll
      for (int j = 0; j < kNT; ++j) mma_s8(acc[i][j], a, b[j]);
    }
  });

  octo::store_tile_as<BM, BN, WM, WN>(out, out_dtype, acc, m, n, row0, col0,
                                      [&](int v, int j, int p) {
    return octo::activate(static_cast<float>(v) * dq[j][p], act);
  });
}

// gemm_tiles.cuh:with_tile's tiles in eight warps by one rule: a warp takes
// BM / 2 rows by BN / 4 columns (16 by 32, 16 or 8), twice mm_fused's four
// warps, so each thread divides half as many elements of a tile, at three
// CTAs an SM or more (the 32 x 32 tile's registers allow four).
template <typename F>
cudaError_t with_q_tile(int tile, F f) {
  return octo::with_tile(tile, [&](auto t) {
    using T = decltype(t);
    return f(octo::Tile<T::BM, T::BN, T::BM / 2, T::BN / 4, 3>{});
  });
}

template <typename T, typename C, typename TA, typename TW>
cudaError_t launch_q(const TA* x, const TW* w, float scale_x, const float* scale_w, void* out,
                     int out_dtype, int m, int k, int n, int act, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<T::BM, T::BN>();
  static_assert(kSmem * T::kMinBlocks <= 227 * 1024, "ring exceeds the SM's shared memory");
  auto kernel =
      mm_fused_q_kernel<T::BM, T::BN, T::WM, T::WN, T::kMinBlocks, C::X, C::W, TA, TW>;
  static std::atomic<uint64_t> opted{0};
  const cudaError_t opt_in = octo::opt_in_smem(kernel, kSmem, opted);
  if (opt_in != cudaSuccess) return opt_in;
  const dim3 grid((n + T::BN - 1) / T::BN, (m + T::BM - 1) / T::BM);
  kernel<<<grid, T::kThreads, kSmem, stream>>>(x, w, scale_x, scale_w, out, out_dtype, m, k, n,
                                               act);
  return cudaSuccess;
}

}  // namespace

// One launch with the plan's tile, an index into kernels/arype_matmul/ops.py:
// TF32X3_TILES, on x of x_dtype and w of w_dtype into out of out_dtype
// (octo::Dtype codes, each f32 or bf16: all eight pairs are built).  A plan
// this file cannot run (a tile out of range, a grid past its limits, an
// unknown dtype code) is refused with cudaErrorInvalidValue and launches
// nothing.
extern "C" int mm_fused_q_launch(const void* x, const void* w, float scale_x,
                                 const void* scale_w, void* out, int m, int k, int n, int act,
                                 int tile, int x_dtype, int w_dtype, int out_dtype,
                                 void* stream) {
  const float* sw = static_cast<const float*>(scale_w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || k < 0 || (m + 31) / 32 > 65535 ||
      (out_dtype != octo::kF32 && out_dtype != octo::kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = octo::with_inputs(x_dtype, w_dtype, [&](auto tx, auto tw) {
    using TA = typename decltype(tx)::type;
    using TW = typename decltype(tw)::type;
    const TA* xp = static_cast<const TA*>(x);
    const TW* wp = static_cast<const TW*>(w);
    const int copy_x = octo::copy_width(xp, k, sizeof(TA));
    const int copy_w = octo::w_copy_width(wp, n, sizeof(TW));
    return with_q_tile(tile, [&](auto t) {
      return octo::with_copies<TA, TW>(copy_x, copy_w, [&](auto c) {
        return launch_q<decltype(t), decltype(c)>(xp, wp, scale_x, sw, out, out_dtype, m, k, n,
                                                  act, s);
      });
    });
  });
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}
