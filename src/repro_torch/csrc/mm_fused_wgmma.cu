// mm_fused's variant C: bf16 x (M,K) @ bf16 w (K,N) at M > 8 on Hopper's bf16
// tensor cores (wgmma), fed by TMA.  The function is the reference's mm_fused
// (src/repro/kernels/arype_matmul/arype_matmul.py:mm_fused, body
// _mm_fused_kernel) on two bf16 operands: jnp.dot(..., preferred_element_type
// =f32), the activation in f32, one rounding to out_dtype.  It runs the
// prefill of every model served on bf16 weights.
//
// Bound: operations, 2MKN bf16 products over 989 TFLOP/s, at every served
// prefill shape (K 6144-28672, N 512-28672, M in the hundreds and thousands).
// The tf32x3 variant (mm_fused_tf32x3.cuh) ran these on tf32 mma.sync at half
// that rate, in 32-row tiles from a 3-stage cp.async ring.  Here:
//   - Tiles.  A CTA computes a BM x BN output tile (BM 128 or 64, BN 128 or
//     64: kernels/arype_matmul/ops.py:mm_fused_plan picks one from the shape)
//     with BM / 64 consumer warpgroups, 64 rows each, and one producer
//     warpgroup.  The grid walks M fastest, so the CTAs in flight share
//     their w column tiles in L2 and the weights stream from device memory
//     about once.
//   - Loads.  One thread of the producer keeps TMA loads
//     (cp.async.bulk.tensor.2d) in flight through a ring of 5 stages of 64-deep
//     K tiles, with a full and an empty mbarrier a stage.  x lands K-major and
//     w N-major (w is (K,N) with N contiguous: 64-column boxes of 64 rows),
//     both in the 128-byte swizzle that wgmma's descriptors name.  TMA
//     zero-fills past M, N and K, so ragged edges need no code in the loop.
//   - Compute.  Each consumer warpgroup runs wgmma.mma_async m64nBNk16 (bf16
//     in, f32 sums) over the stage, B through the instruction's transpose-B bit.
//   - Promotion.  The tensor cores' f32 sums truncate, and the error of a sum
//     carried over all of K grows with K (the card showed it for tf32 at
//     K 3072, mm_fused.cu).  So each 64-deep K tile sums from zero (scale-d 0
//     on its first k16 step) and is then added into the f32 accumulators with
//     one round-to-nearest add: two register sets of BN / 2 floats a thread.
//   - Order.  The K tile depth, the k16 order inside it and the promotion
//     points are constants of the kernel, so a row's bits depend neither on
//     M, nor on the tile, nor on the other rows.  The order differs from the
//     tf32x3 variant's (k8 steps, 32-deep tiles), so the two do not agree bit
//     for bit; the card holds this one to an f64 product and the plain twin.
//   - Epilogue.  The activation (common.cuh:activate) and one rounding to
//     out_dtype (to nearest even for bf16) in gemm_tiles.cuh:store_tile_as,
//     masked past M and N.
// The tensor maps are encoded on the host at each launch
// (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so the
// library needs no -lcuda) and passed as __grid_constant__ parameters.  TMA
// needs 16-byte aligned bases and row strides (K and N multiples of 8); the
// plan sends every other bf16 x bf16 operand pair to the tf32x3 variant.
//
// Left for later: a persistent scheduler whose epilogue overlaps the next
// tile's loads, clusters with multicast loads, wider tiles, a TMA store.
#include <cuda.h>  // CUtensorMap and its enums; no driver symbol is linked
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"
#include "gemm_tiles.cuh"

namespace octo {
namespace {

constexpr int kWgMinRows = 9;                    // M <= 8 is the skinny variant's
constexpr int kWgBK = 64;                        // K tile: 64 bf16, one 128-byte swizzled row
constexpr int kWgSteps = kWgBK / 16;             // wgmma k16 steps a K tile
constexpr int kWgStages = 5;                     // TMA ring depth
constexpr int kWgBox = 64;                       // columns of a TMA box: 128 bytes of bf16
constexpr int kWgBoxBytes = kWgBK * kWgBox * 2;  // one 64 x 64 box of w

// The tiles of kernels/arype_matmul/ops.py:WGMMA_TILES by index.
template <int BM_, int BN_>
struct WgTile {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int kConsumers = BM / 64;  // warpgroups of 64 rows
  static constexpr int kThreads = (kConsumers + 1) * 128;
  static constexpr int kABytes = BM * kWgBK * 2;
  static constexpr int kStageBytes = kABytes + kWgBK * BN * 2;
  // the ring, 1024-byte aligned (the swizzle's period) by hand, then the
  // full and empty barriers
  static constexpr int kSmem = kWgStages * kStageBytes + 1024 + 2 * kWgStages * 8;
};

template <typename F>
cudaError_t with_wgmma_tile(int tile, F f) {
  switch (tile) {
    case 0:
      return f(WgTile<128, 128>{});
    case 1:
      return f(WgTile<128, 64>{});
    case 2:
      return f(WgTile<64, 128>{});
    case 3:
      return f(WgTile<64, 64>{});
    default:
      return cudaErrorInvalidValue;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Spins until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// The box of `map` at (column c, row r) into shared memory at dst; its bytes
// complete a transaction of `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c,
                                         int r) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c), "r"(r)
      : "memory");
}

// A wgmma shared-memory descriptor in the 128-byte swizzle: start address,
// leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lead, uint32_t stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lead >> 4) << 16 | static_cast<uint64_t>(stride >> 4) << 32 |
         uint64_t{1} << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads of wgmma's registers across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x BN, BN / 2 f32 a thread) = A B, or A B + D where scale_d is 1: A
// K-major and B N-major (trans-b 1), both through 128-byte-swizzle descriptors.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_step(float (&d)[BN / 2], uint64_t da, uint64_t db,
                                           int scale_d) {
  if constexpr (BN == 128)
    wgmma_n128(d, da, db, scale_d);
  else
    wgmma_n64(d, da, db, scale_d);
}

template <int BM, int BN>
__global__ void __launch_bounds__(WgTile<BM, BN>::kThreads, 1)
mm_wgmma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                void* __restrict__ out, int out_dtype, int m, int k, int n, int act) {
  using T = WgTile<BM, BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kWgStages * T::kStageBytes);
  uint64_t* empty = full + kWgStages;
  const int row0 = blockIdx.x * BM;  // the grid walks M fastest
  const int col0 = blockIdx.y * BN;
  const int tiles = (k + kWgBK - 1) / kWgBK;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);                   // the producer's expect_tx
      mbar_init(&empty[s], T::kConsumers * 4);  // one arrive a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == T::kConsumers) {
    // the producer warpgroup: one thread keeps the ring full
    if constexpr (T::kConsumers == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == T::kConsumers * 128) {
      for (int t = 0; t < tiles; ++t) {
        const int s = t % kWgStages;
        if (t >= kWgStages) mbar_wait(&empty[s], (t / kWgStages - 1) & 1);
        uint8_t* a = ring + s * T::kStageBytes;
        mbar_expect_tx(&full[s], T::kStageBytes);  // whole boxes, zero-filled ones too
        tma_load(a, &tx, &full[s], t * kWgBK, row0);
#pragma unroll
        for (int j = 0; j < BN / kWgBox; ++j)
          tma_load(a + T::kABytes + j * kWgBoxBytes, &tw, &full[s], col0 + j * kWgBox, t * kWgBK);
      }
    }
  } else {
    if constexpr (T::kConsumers == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float acc[1][BN / 8][4];  // store_tile's layout of the m64nBN fragment
    float tile[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      acc[0][i / 4][i % 4] = 0.f;
      tile[i] = 0.f;
    }
    for (int t = 0; t < tiles; ++t) {
      const int s = t % kWgStages;
      mbar_wait(&full[s], (t / kWgStages) & 1);
      const uint32_t a = smem_addr(ring + s * T::kStageBytes) + wg * 64 * 128;
      const uint32_t b = smem_addr(ring + s * T::kStageBytes + T::kABytes);
      fence_regs(tile);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgSteps; ++kk) {
        // A: rows of 128 bytes, 8-row groups 1024 apart, k16 = 32 bytes on;
        // B: 64-column boxes 8192 bytes apart, 8 K rows 1024 apart, k16 =
        // 16 rows of 128 bytes on.  The K tile's first step starts from 0.
        wgmma_step<BN>(tile, sw128_desc(a + kk * 32, 16, 1024),
                       sw128_desc(b + kk * 16 * 128, kWgBoxBytes, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(tile);
      // the stage goes back to the producer, the tile's sum into acc
      if (threadIdx.x % 32 == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[0][i / 4][i % 4] += tile[i];
    }
    store_tile_as<BM, BN, 16, BN>(out, out_dtype, acc, m, n, row0, col0,
                                  [act](float v, int, int) { return activate(v, act); });
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once; null if the driver
// has none.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The TMA map of a row-major (rows, cols) bf16 matrix at `base` in boxes of
// 64 columns by box_rows, 128-byte swizzled, zero-filled past its edges.
bool bf16_map(EncodeTiled encode, CUtensorMap* map, const void* base, int rows, int cols,
              int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {kWgBox, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// One launch of WGMMA_TILES[tile] on bf16 x (M,K) and bf16 w (K,N) into out
// of out_dtype.  Refused with cudaErrorInvalidValue, launching nothing: M <=
// 8 (the skinny variant's), K not a positive multiple of 8, N not a multiple
// of 8, a base not 16-byte aligned, a tile out of range, a grid past its
// limits.
cudaError_t mm_fused_wgmma(const void* x, const void* w, void* out, int out_dtype, int m, int k,
                           int n, int act, int tile, cudaStream_t s) {
  if (m < kWgMinRows || k <= 0 || k % 8 || n % 8 || !aligned(x, 16) || !aligned(w, 16))
    return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  return with_wgmma_tile(tile, [&](auto t) -> cudaError_t {
    using T = decltype(t);
    const dim3 grid((m + T::BM - 1) / T::BM, (n + T::BN - 1) / T::BN);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    CUtensorMap tx, tw;
    if (!bf16_map(encode, &tx, x, m, k, T::BM) || !bf16_map(encode, &tw, w, k, n, kWgBK))
      return cudaErrorInvalidValue;
    auto kernel = mm_wgmma_kernel<T::BM, T::BN>;
    static std::atomic<uint64_t> opted{0};
    const cudaError_t opt_in = opt_in_smem(kernel, T::kSmem, opted);
    if (opt_in != cudaSuccess) return opt_in;
    kernel<<<grid, T::kThreads, T::kSmem, s>>>(tx, tw, out, out_dtype, m, k, n, act);
    return cudaSuccess;
  });
}

}  // namespace octo
