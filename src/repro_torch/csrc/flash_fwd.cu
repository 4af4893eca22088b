// flash_fwd: attention forward with an online softmax over KV tiles and the
// tiles that the mask rules out skipped; causal, local (sliding window) and
// full masks, keys at or past kv_len masked.
//
// Replaces src/repro/kernels/flash_attention/flash_attention.py:flash_fwd
// (body _flash_kernel), whose running m/l/acc stay in VMEM scratch across the
// KV grid axis and whose causal/local masks skip whole KV blocks.
//
// Bound: two chained products of 2*Sq*Sk*D FLOPs each (halved by a causal
// mask) against reading q, k, v and writing out once.  At the LM's prefill
// shapes (D 128, a few hundred rows) that is operations-bound on the card's
// f32 rate; this SIMT kernel is far from it (no tensor cores, no TMA:
// wgmma and a TMA ring are later work).
//
// Design: one block of 8 warps per (batch*head, 64-row query tile); each warp
// owns 8 query rows and keeps their f32 m, l and acc in registers (acc split
// over the 32 lanes along D, ceil(D/32) values a lane: the VMEM scratch's
// place).  The query tile (scaled on load, as the reference scales q before
// the dot), and one 32-key K and V tile at a time, sit in shared memory as
// f32; a lane computes the scores of one key for the warp's 8 rows, the warp
// reduces their max and sum with shuffles, and the P@V product broadcasts each
// key's p with a shuffle.  The loop over KV tiles starts and stops where the
// mask allows (causal: keys past the tile's last row; local: keys before its
// first row's window; kv_len), so masked tiles are never loaded.  Ragged Sq
// and Sk are masked here, so the wrapper pads nothing; GQA reads the shared
// KV head in place and the inputs and the output are addressed by strides,
// so neither the head repeat nor a layout change is copied.  Inputs f32 or
// bf16, arithmetic f32, output in the input type.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8, kRows = 8, kBQ = kWarps * kRows, kBK = 32;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF, not -inf
enum Mask : int { kFull = 0, kCausal = 1, kLocal = 2 };

struct Params {
  int hq, group, sq, sk, d, mask, window, kv_len;
  float scale;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

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
template <typename T, int DT>
__global__ void __launch_bounds__(kThreads, 1)  // one block an SM is enough
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, const Params p) {
  extern __shared__ __align__(16) float smem[];  // float4 reads of the q tile
  const int d = p.d, kstride = d + 1;  // padded K rows: lanes read distinct banks
  float* qs = smem;                    // kBQ x d, scaled
  float* ks = qs + kBQ * d;            // kBK x (d + 1)
  float* vs = ks + kBK * kstride;      // kBK x d
  const int bh = blockIdx.y, b = bh / p.hq, h = bh % p.hq, hk = h / p.group;
  const int q0 = blockIdx.x * kBQ;
  const T* qb = q + b * p.q_sb + h * p.q_sh;
  const T* kb = k + b * p.k_sb + hk * p.k_sh;
  const T* vb = v + b * p.v_sb + hk * p.v_sh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = q0 + warp * kRows;

  for (int i = threadIdx.x; i < kBQ * d; i += kThreads) {
    const int r = i / d, c = i % d, qi = q0 + r;
    qs[i] = qi < p.sq ? to_f32(qb[qi * p.q_ss + c]) * p.scale : 0.f;
  }

  float acc[kRows][DT], m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < DT; ++t) acc[r][t] = 0.f;
  }

  // keys [k_lo, k_hi) hold every valid key of the tile's rows
  const int k_valid = min(p.kv_len, p.sk);
  const int q_last = min(q0 + kBQ, p.sq) - 1;
  int k_hi = k_valid, k_lo = 0;
  if (p.mask != kFull) k_hi = min(k_hi, q_last + 1);
  if (p.mask == kLocal) k_lo = max(0, q0 - p.window + 1);
  k_lo -= k_lo % kBK;

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the previous tile (and, first, nothing) is consumed
    for (int i = threadIdx.x; i < kBK * d; i += kThreads) {
      const int r = i / d, c = i % d, kj = k0 + r;
      const bool in = kj < p.sk;
      ks[r * kstride + c] = in ? to_f32(kb[kj * p.k_ss + c]) : 0.f;
      vs[i] = in ? to_f32(vb[kj * p.v_ss + c]) : 0.f;
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
    T* orow = out + b * p.o_sb + h * p.o_sh + qi * p.o_ss;
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      const int c = lane + 32 * t;
      if (c < d) orow[c] = from_f32<T>(acc[r][t] / lr);
    }
  }
}

template <typename T, int DT>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int bh,
                   const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kBQ * p.d + kBK * (p.d + 1) + kBK * p.d);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBQ - 1) / kBQ, bh);
  flash_fwd_kernel<T, DT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, int bh,
                     const Params& p, cudaStream_t stream) {
  switch ((p.d + 31) / 32) {
    case 1: return launch<T, 1>(q, k, v, out, bh, p, stream);
    case 2: return launch<T, 2>(q, k, v, out, bh, p, stream);
    case 3: return launch<T, 3>(q, k, v, out, bh, p, stream);
    case 4: return launch<T, 4>(q, k, v, out, bh, p, stream);
    case 5: return launch<T, 5>(q, k, v, out, bh, p, stream);
    case 6: return launch<T, 6>(q, k, v, out, bh, p, stream);
    case 7: return launch<T, 7>(q, k, v, out, bh, p, stream);
    case 8: return launch<T, 8>(q, k, v, out, bh, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,Hq,Sq,D), k/v (B,Hkv,Sk,D), out (B,Hq,Sq,D), each addressed by its
// batch, head and row strides (elements; D contiguous).  bf16 != 0: all four
// are bf16, else f32.  mask: 0 full, 1 causal, 2 local.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* out,
                                int bf16, int b, int hq, int hkv, int sq, int sk, int d,
                                int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
                                int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
                                int64_t v_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss,
                                int mask, int window, int kv_len, float scale, void* stream) {
  if (d <= 0 || d > 256 || d % 8 != 0 || hkv <= 0 || hq % hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{hq, hq / hkv, sq, sk, d, mask, window, kv_len, scale,
                 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bf16 ? dispatch<__nv_bfloat16>(q, k, v, out, b * hq, p, s)
                               : dispatch<float>(q, k, v, out, b * hq, p, s);
  return static_cast<int>(err);
}
