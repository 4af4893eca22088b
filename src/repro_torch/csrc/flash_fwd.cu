// flash_fwd: attention forward with an online softmax over KV tiles and the
// tiles that the mask rules out skipped; causal, local (sliding window) and
// full masks, keys at or past kv_len masked.
//
// Replaces src/repro/kernels/flash_attention/flash_attention.py:flash_fwd
// (body _flash_kernel), whose running m/l/acc stay in VMEM scratch across the
// KV grid axis and whose causal/local masks skip whole KV blocks.  What both
// variants compute is the reference's: f32 scores of the inputs, scaled;
// NEG_INF (-1e30) for masked scores; m, l and alpha in f32 with masked p 0;
// an f32 P@V; l == 0 -> 1; the output rounded once to the input type.
//
// Bound: two chained products of 2*Sq*D FLOPs for every valid (query, key)
// pair against reading q, k, v and writing out once.  At the LM's prefill
// shapes (D 128 or 256, a few hundred rows) that is the bytes in bf16 (4 D
// FLOPs a pair at 989 TFLOP/s is below them) and the operations in f32.
//
// Two kernels sit behind the one entry point flash_fwd_launch, one for each
// type; kernels/flash_attention/ops.py:flash_plan picks the tile (an index
// into FLASH_TILES there) from D and the type, and every call is one launch.
// Both walk, for each (batch*head, 64-row query tile) block, only the KV
// tiles that hold a valid key of the block's rows (causal: none past its last
// row; local: none before its first row's window; kv_len), so masked tiles
// are never loaded.  Ragged Sq and Sk are masked here, so the wrapper pads
// nothing; GQA reads the shared KV head in place and the inputs and the
// output are addressed by strides, so neither the head repeat nor a layout
// change is copied.
//
// f32: SIMT.  One block of 8 warps; each warp owns 8 query rows and keeps
// their f32 m, l and acc in registers (acc split over the 32 lanes along D,
// ceil(D/32) values a lane: the VMEM scratch's place).  The query tile
// (scaled on load, as the reference scales q before the dot), and one 32-key
// K and V tile at a time, sit in shared memory; a lane computes the scores of
// one key for the warp's 8 rows, the warp reduces their max and sum with
// shuffles, and the P@V product broadcasts each key's p with a shuffle.  It
// is already under SDPA's f32 time (PERF.md); no tensor core takes f32.
//
// bf16: tensor cores, mma.sync m16n8k16 bf16 -> f32.  4 warps own 16 query
// rows each (a 64-row tile); bf16 Q, K and V land in shared memory with
// 16-byte cp.async copies (element loads where a base or stride is not
// 16-byte aligned), K and V in a 2-stage ring of 32-key tiles, rows padded by
// 16 bytes so that ldmatrix's eight rows hit distinct banks; ragged Sq and Sk,
// and D up to the tile's width DP (the narrowest of 16, 32, 64, 128, 256 that
// holds it), are zero-filled.  Shared memory: 15-52 KB up to DP 128 (the
// LM's D 128), 99 KB at DP 256, where the f32 O fragment alone is 128
// registers a thread.  What
// the H100 showed (PERF.md): at these prompt lengths the kernel is
// bound by the latency of each warp's chain of tiles, not by a pipe, so 32-
// rather than 64-key tiles (more blocks resident, less of a causal diagonal
// tile wasted), the query tiles launched last-first (under a causal mask they
// walk the most keys, so they start first) and loops over DP with no bound
// on D (the compiler keeps a whole k-step loop in one block and schedules its
// ldmatrix ahead of the mma) took the LM's 258-token prefill from 46.1 to
// 30.5 us on an H100 (chip_smoke.py --kernel-times); a third stage, launch
// bounds and Q fragments held in registers did not help.
//   S = Q K^T: ldmatrix for Q's A fragments and for K's rows as the .col B
// operand; bf16 products are exact in f32.  The scale multiplies the f32
// accumulator (with log2(e) folded in, for exp2f), where the reference scales
// q before the dot: the two differ by f32 rounding.
//   The softmax runs on the fragments: each row's four lanes (a quad) reduce
// its max with two xor shuffles; the mask is applied per element from the
// fragment's (row, key) coordinates only in tiles that cross an edge, as -inf
// (m starts at NEG_INF, so a masked p is 0 and alpha finite, as the
// reference's where); l sums the f32 p, a lane's partial summed over its quad
// at the end.
//   P @ V: p is split in registers into hi = bf16(p) and lo = bf16(p - hi),
// each repacked as A fragments (the S fragment of two key tiles is the A
// fragment of one 16-key step), and both run against V's B fragments
// (ldmatrix.trans of V's row-major tile) into the f32 O fragment that alpha
// rescales.  Why the split: the reference multiplies f32 p by V; p rounded to
// bf16 alone (SDPA's and FlashAttention's function) is off by up to 2^-9 of
// each p, and its worst error on the LM's shapes is 30-100 times what the
// bf16 tolerance (one step of the output) allows, where hi + lo carries p to
// about 2^-17 and stays within it (tests/test_torch_flash_plan.py emulates
// both, and prints the shares when run as a script).  V is bf16 already, so it
// needs no lo part.  The second product is the design's cost, not the
// function's work: the bound counts 4 D FLOPs a valid pair.
//   Left for later: wgmma (64-row warpgroup products from shared memory),
// TMA loads and a warp-specialised producer.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"
#include "gemm_tiles.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF, not -inf
enum Mask : int { kFull = 0, kCausal = 1, kLocal = 2 };

struct Params {
  int hq, group, sq, sk, d, mask, window, kv_len;
  float scale;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
};

// [k_lo, k_hi): the keys that hold every valid key of query rows [q0, q_end),
// k_lo rounded down to a multiple of bk
__device__ __forceinline__ void key_range(const Params& p, int q0, int q_end, int bk, int& k_lo,
                                          int& k_hi) {
  const int k_valid = min(p.kv_len, p.sk);
  k_hi = k_valid;
  k_lo = 0;
  if (p.mask != kFull) k_hi = min(k_hi, q_end);
  if (p.mask == kLocal) k_lo = max(0, q0 - p.window + 1);
  k_lo -= k_lo % bk;
}

__device__ __forceinline__ bool valid_pair(const Params& p, int qi, int kj) {
  bool valid = kj < min(p.kv_len, p.sk);
  if (p.mask == kCausal) valid = valid && qi >= kj;
  if (p.mask == kLocal) valid = valid && qi >= kj && qi - kj < p.window;
  return valid;
}

// ------------------------------------------------------------------- f32, SIMT

constexpr int kWarps = 8, kRows = 8, kBQ = kWarps * kRows, kBK = 32;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// DT = ceil(D / 32): acc values a lane holds for each row.
template <int DT>
__global__ void __launch_bounds__(kThreads, 1)  // one block an SM is enough
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, const Params p) {
  extern __shared__ __align__(16) float smem[];  // float4 reads of the q tile
  const int d = p.d, kstride = d + 1;  // padded K rows: lanes read distinct banks
  float* qs = smem;                    // kBQ x d, scaled
  float* ks = qs + kBQ * d;            // kBK x (d + 1)
  float* vs = ks + kBK * kstride;      // kBK x d
  const int bh = blockIdx.y, b = bh / p.hq, h = bh % p.hq, hk = h / p.group;
  const int q0 = blockIdx.x * kBQ;
  const float* qb = q + b * p.q_sb + h * p.q_sh;
  const float* kb = k + b * p.k_sb + hk * p.k_sh;
  const float* vb = v + b * p.v_sb + hk * p.v_sh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = q0 + warp * kRows;

  for (int i = threadIdx.x; i < kBQ * d; i += kThreads) {
    const int r = i / d, c = i % d, qi = q0 + r;
    qs[i] = qi < p.sq ? qb[qi * p.q_ss + c] * p.scale : 0.f;
  }

  float acc[kRows][DT], m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < DT; ++t) acc[r][t] = 0.f;
  }

  int k_lo, k_hi;
  key_range(p, q0, min(q0 + kBQ, p.sq), kBK, k_lo, k_hi);
  const int k_valid = min(p.kv_len, p.sk);

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the previous tile (and, first, nothing) is consumed
    for (int i = threadIdx.x; i < kBK * d; i += kThreads) {
      const int r = i / d, c = i % d, kj = k0 + r;
      const bool in = kj < p.sk;
      ks[r * kstride + c] = in ? kb[kj * p.k_ss + c] : 0.f;
      vs[i] = in ? vb[kj * p.v_ss + c] : 0.f;
    }
    __syncthreads();

    // scores of key k0 + lane against the warp's rows
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* krow = ks + lane * kstride;
    const float* qrow = qs + warp * kRows * d;
    for (int c = 0; c < d; c += 4) {  // d is a multiple of 8
      const float k0v = krow[c], k1v = krow[c + 1], k2v = krow[c + 2], k3v = krow[c + 3];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qrow + r * d + c);
        s[r] = fmaf(qv.x, k0v, s[r]);
        s[r] = fmaf(qv.y, k1v, s[r]);
        s[r] = fmaf(qv.z, k2v, s[r]);
        s[r] = fmaf(qv.w, k3v, s[r]);
      }
    }

    const int kj = k0 + lane;
    float pr[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = row0 + r;
      bool valid = kj < k_valid;
      if (p.mask == kCausal) valid = valid && qi >= kj;
      if (p.mask == kLocal) valid = valid && qi >= kj && qi - kj < p.window;
      const float sv = valid ? s[r] : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sv));
      // masked -> 0: without it a fully masked row would get exp(0) = 1s
      pr[r] = valid ? expf(sv - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(pr[r]);
      m[r] = m_new;
#pragma unroll
      for (int t = 0; t < DT; ++t) acc[r][t] *= alpha;
    }

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vj[DT];
#pragma unroll
      for (int t = 0; t < DT; ++t) {
        const int c = lane + 32 * t;
        vj[t] = c < d ? vs[j * d + c] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(0xffffffffu, pr[r], j);
#pragma unroll
        for (int t = 0; t < DT; ++t) acc[r][t] = fmaf(pj, vj[t], acc[r][t]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = row0 + r;
    if (qi >= p.sq) continue;
    const float lr = l[r] == 0.f ? 1.f : l[r];  // fully masked rows -> zeros, not NaN
    float* orow = out + b * p.o_sb + h * p.o_sh + qi * p.o_ss;
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      const int c = lane + 32 * t;
      if (c < d) orow[c] = acc[r][t] / lr;
    }
  }
}

template <int DT>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* out, int bh,
                        const Params& p, cudaStream_t stream) {
  if (p.d > 32 * DT) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (kBQ * p.d + kBK * (p.d + 1) + kBK * p.d);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBQ - 1) / kBQ, bh);
  flash_fwd_kernel<DT><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), p);
  return cudaGetLastError();
}

// --------------------------------------------------------- bf16, tensor cores

using octo::bf16_bits;
constexpr int kMmaWarps = 4, kMmaBQ = 16 * kMmaWarps, kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of the (DP, BK) tile: the query tile and the K/V ring, rows
// of DP + 8 bf16 (kernels/flash_attention/ops.py:FlashPlan.smem_bytes)
template <int DP, int BK>
constexpr int mma_smem_bytes() {
  return 2 * (DP + 8) * (kMmaBQ + kMmaStages * 2 * BK);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16_bits* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16_bits* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (m16n8 f32) += a (m16k16 bf16, row) * b (k16n8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) -> hi = bf16(a), bf16(b) and lo = bf16(a - hi_a), bf16(b - hi_b),
// each pair one .b32 register with a in the low half, as mma's fragments hold
// the lower column there
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// rows [0, rows) of a tile of DP columns at dst (stride DP + 8) from rows
// row0.. of src (row stride `stride` elements), 16-byte chunks; a chunk past
// `valid` rows or past D is zero-filled.  vec: cp.async copies, else element
// loads (a base or stride that is not 16-byte aligned).
template <int DP>
__device__ __forceinline__ void load_rows(bf16_bits* dst, const bf16_bits* src, int64_t stride,
                                          int row0, int rows, int valid, int d, bool vec) {
  constexpr int kChunks = DP / 8, kS = DP + 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += kMmaThreads) {
    const int r = i / kChunks, c = i % kChunks * 8;
    const bool ok = r < valid && c < d;
    const bf16_bits* s = ok ? src + (row0 + r) * stride + c : src;
    bf16_bits* t = dst + r * kS + c;
    if (vec) {
      octo::cp_async<16>(t, s, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) t[e] = ok ? s[e] : bf16_bits{0};
    }
  }
}

template <int DP, int BK>
__global__ void __launch_bounds__(kMmaThreads)
flash_mma_kernel(const bf16_bits* __restrict__ q, const bf16_bits* __restrict__ k,
                 const bf16_bits* __restrict__ v, __nv_bfloat16* __restrict__ out,
                 const Params p, const bool vec) {
  constexpr int kS = DP + 8;         // row stride of every shared tile
  constexpr int kNT = BK / 8;        // key tiles (n8) of a score fragment row
  constexpr int kDT = DP / 8;        // column tiles (n8) of the output
  extern __shared__ __align__(16) bf16_bits sm[];
  bf16_bits* qs = sm;                // kMmaBQ x kS
  bf16_bits* ring = qs + kMmaBQ * kS;  // stage s: K at s * 2 * BK * kS, V BK * kS on

  const int bh = blockIdx.y, b = bh / p.hq, h = bh % p.hq, hk = h / p.group;
  // the last query tiles first: under a causal mask they walk the most keys
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kMmaBQ;
  const int d = p.d;
  const bf16_bits* qb = q + b * p.q_sb + h * p.q_sh;
  const bf16_bits* kb = k + b * p.k_sb + hk * p.k_sh;
  const bf16_bits* vb = v + b * p.v_sb + hk * p.v_sh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;  // the fragments' group and thread in group
  const int w0 = q0 + warp * 16;             // the warp's first query row
  const int qi[2] = {w0 + gid, w0 + gid + 8};

  int k_lo, k_hi;
  key_range(p, q0, min(q0 + kMmaBQ, p.sq), BK, k_lo, k_hi);
  const int tiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;
  const int k_valid = min(p.kv_len, p.sk);
  // the warp's own rows: tiles past (causal, local) or before (local) them add nothing
  const int w_last = min(w0 + 15, p.sq - 1);
  const bool w_live = w0 < p.sq;

  auto load_kv = [&](int t) {
    const int k0 = k_lo + t * BK;
    bf16_bits* ks = ring + (t % kMmaStages) * 2 * BK * kS;
    load_rows<DP>(ks, kb, p.k_ss, k0, BK, p.sk - k0, d, vec);
    load_rows<DP>(ks + BK * kS, vb, p.v_ss, k0, BK, p.sk - k0, d, vec);
  };
  load_rows<DP>(qs, qb, p.q_ss, q0, kMmaBQ, p.sq - q0, d, vec);
  if (tiles > 0) load_kv(0);
  octo::cp_async_commit();

  float o[kDT][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  const float scale_log2 = p.scale * kLog2e;
  const float kMinusInf = __uint_as_float(0xff800000u);  // -inf: exp2 gives 0

  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) load_kv(t + 1);
    octo::cp_async_commit();
    octo::cp_async_wait<1>();
    __syncthreads();  // tile t (and, first, the query tile) landed for every thread
    const int k0 = k_lo + t * BK;
    bool live = w_live;
    if (p.mask != kFull) live = live && k0 <= w_last;
    if (p.mask == kLocal) live = live && k0 + BK - 1 > w0 - p.window;
    if (live) {
      const bf16_bits* ks = ring + (t % kMmaStages) * 2 * BK * kS;
      const bf16_bits* vs = ks + BK * kS;

      // S = Q K^T, f32
      float s[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, qs + (warp * 16 + lane % 16) * kS + kk * 16 + lane / 16 * 8);
#pragma unroll
        for (int j = 0; j < kNT; j += 2) {
          uint32_t bk[4];
          ldsm_x4(bk, ks + (j * 8 + lane % 8 + lane / 16 * 8) * kS + kk * 16 + lane / 8 % 2 * 8);
          mma_bf16(s[j], a, bk[0], bk[1]);
          mma_bf16(s[j + 1], a, bk[2], bk[3]);
        }
      }

      // scale (log2 units), mask where the tile crosses an edge, row max
      bool edge = k0 + BK > k_valid;
      if (p.mask != kFull) edge = edge || k0 + BK - 1 > w0;
      if (p.mask == kLocal) edge = edge || w_last - k0 >= p.window;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float sv = s[j][e] * scale_log2;
          if (edge && !valid_pair(p, qi[e / 2], k0 + j * 8 + tig * 2 + e % 2)) sv = kMinusInf;
          s[j][e] = sv;
          mx[e / 2] = fmaxf(mx[e / 2], sv);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f(m[r] - mx[r]);  // m starts at NEG_INF: both finite
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < kDT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e / 2];

      // p = exp2(s - m) (a masked -inf gives 0), l += p, then P @ V with p
      // split into bf16 hi + lo, 16 keys a step
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float(&sj)[4] = s[2 * kt + half];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sj[e] = exp2f(sj[e] - m[e / 2]);
            l[e / 2] += sj[e];
          }
          // A fragment: a0 (row gid, keys 0-7 of the step), a1 (row gid + 8),
          // a2, a3 the same for keys 8-15
          split_bf16(sj[0], sj[1], hi[2 * half], lo[2 * half]);
          split_bf16(sj[2], sj[3], hi[2 * half + 1], lo[2 * half + 1]);
        }
#pragma unroll
        for (int j = 0; j < kDT; j += 2) {
          uint32_t bv[4];
          ldsm_x4_trans(bv, vs + (kt * 16 + lane % 8 + lane / 8 % 2 * 8) * kS + j * 8 +
                                lane / 16 * 8);
          mma_bf16(o[j], hi, bv[0], bv[1]);
          mma_bf16(o[j], lo, bv[0], bv[1]);
          mma_bf16(o[j + 1], hi, bv[2], bv[3]);
          mma_bf16(o[j + 1], lo, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // stage t % 2 is read before tile t + 2 overwrites it
  }
  octo::cp_async_wait<0>();

  // l over the row's quad; l == 0 (a fully masked row) -> 1, so its zeros stay
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (l[r] == 0.f) l[r] = 1.f;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= p.sq) continue;
    __nv_bfloat16* orow = out + b * p.o_sb + h * p.o_sh + qi[r] * p.o_ss;
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      const int c = j * 8 + tig * 2;
      if (c < d) octo::put2(orow + c, o[j][2 * r] / l[r], o[j][2 * r + 1] / l[r]);
    }
  }
}

template <int DP, int BK>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, int bh,
                       const Params& p, cudaStream_t stream) {
  constexpr int kSmem = mma_smem_bytes<DP, BK>();
  static_assert(kSmem <= 227 * 1024, "the tile exceeds a block's shared memory");
  if (p.d > DP) return cudaErrorInvalidValue;
  auto kernel = flash_mma_kernel<DP, BK>;
  static std::atomic<uint64_t> opted{0};
  const cudaError_t err = octo::opt_in_smem(kernel, kSmem, opted);
  if (err != cudaSuccess) return err;
  // 16-byte copies need every row of q, k and v to start 16-byte aligned
  const bool vec = octo::aligned(q, 16) && octo::aligned(k, 16) && octo::aligned(v, 16) &&
                   (p.q_sb | p.q_sh | p.q_ss | p.k_sb | p.k_sh | p.k_ss | p.v_sb | p.v_sh |
                    p.v_ss) % 8 == 0;
  const dim3 grid((p.sq + kMmaBQ - 1) / kMmaBQ, bh);
  kernel<<<grid, kMmaThreads, kSmem, stream>>>(
      static_cast<const bf16_bits*>(q), static_cast<const bf16_bits*>(k),
      static_cast<const bf16_bits*>(v), static_cast<__nv_bfloat16*>(out), p, vec);
  return cudaGetLastError();
}

// The tiles by index, as kernels/flash_attention/ops.py:FLASH_TILES lists
// them: 0-7 SIMT (f32; DT = index + 1), 8-12 mma (bf16; DP 16 to 256).
cudaError_t dispatch(int tile, bool bf16, const void* q, const void* k, const void* v,
                     void* out, int bh, const Params& p, cudaStream_t s) {
  if (bf16 != (tile >= 8)) return cudaErrorInvalidValue;
  switch (tile) {
    case 0: return launch_simt<1>(q, k, v, out, bh, p, s);
    case 1: return launch_simt<2>(q, k, v, out, bh, p, s);
    case 2: return launch_simt<3>(q, k, v, out, bh, p, s);
    case 3: return launch_simt<4>(q, k, v, out, bh, p, s);
    case 4: return launch_simt<5>(q, k, v, out, bh, p, s);
    case 5: return launch_simt<6>(q, k, v, out, bh, p, s);
    case 6: return launch_simt<7>(q, k, v, out, bh, p, s);
    case 7: return launch_simt<8>(q, k, v, out, bh, p, s);
    case 8: return launch_mma<16, 32>(q, k, v, out, bh, p, s);
    case 9: return launch_mma<32, 32>(q, k, v, out, bh, p, s);
    case 10: return launch_mma<64, 32>(q, k, v, out, bh, p, s);
    case 11: return launch_mma<128, 32>(q, k, v, out, bh, p, s);
    case 12: return launch_mma<256, 32>(q, k, v, out, bh, p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,Hq,Sq,D), k/v (B,Hkv,Sk,D), out (B,Hq,Sq,D), each addressed by its
// batch, head and row strides (elements; D contiguous).  bf16 != 0: all four
// are bf16, else f32.  mask: 0 full, 1 causal, 2 local.  tile: the plan's
// index (flash_plan); a tile of the other type or narrower than D is refused
// with cudaErrorInvalidValue and launches nothing.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* out,
                                int bf16, int b, int hq, int hkv, int sq, int sk, int d,
                                int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
                                int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
                                int64_t v_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss,
                                int mask, int window, int kv_len, float scale, int tile,
                                void* stream) {
  if (d <= 0 || d > 256 || d % 8 != 0 || hkv <= 0 || hq % hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{hq, hq / hkv, sq, sk, d, mask, window, kv_len, scale,
                 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  return static_cast<int>(dispatch(tile, bf16 != 0, q, k, v, out, b * hq, p,
                                   static_cast<cudaStream_t>(stream)));
}
