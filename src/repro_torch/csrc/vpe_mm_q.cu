// vpe_mm_q: int8 small/skinny (M,K) @ (K,N) with int32 accumulation, the
// per-channel dequant and a fused activation, from f32 or bf16 operands into
// an f32 or bf16 output, in one launch.
//
// Replaces src/repro/kernels/vpe_smallmm/vpe_smallmm.py:vpe_mm_q (body
// _vpe_q_kernel) together with the quantize, pad and slice ops its wrapper
// (ops.py:vpe_matmul_q) runs around it: this kernel reads x and w, quantizes
// both on load (a bf16 element divided as its exact f32, as the reference's
// quantize_i8 divides v.astype(f32)), and writes the output, rounded once to
// its type (out_dtype or x.dtype in the reference's wrapper).
//
// Bound: at the shapes the router sends here (K*N small, M up to a few
// thousand rows) the launch and one memory round trip; past them, reading x
// (M*K*4 bytes) and writing out (M*N*4 bytes).  Each code costs an IEEE
// division, so the division count, not the K integer multiply-adds an
// output, is the arithmetic to keep down.
//
// Design (kernels/vpe_smallmm/ops.py:vpe_q_plan gives the tile): a CTA owns a
// bm x bn tile of the output and walks K in steps of bk.  A step quantizes the
// tile's x codes (bm x bk) and weight codes (bk x bn) into shared memory in
// one pass over all threads, then one barrier, then each thread sums the
// outputs it owns (at most eight, mapped with 32-bit arithmetic, one
// division a thread) from the staged codes.  At these sizes the time is the
// launch and the reads' round trips, so every read is issued before any use
// of one waits: the weight scales unconditionally, the codes' operands
// kStage a thread before their quantizes.  Every x element is
// quantized once a column tile (once in all, where N fits one tile, as at
// every pipeline shape) and every weight once a CTA.  The sum is int32 and
// exact (the wrapper checks K * 127^2 < 2^31), so no summation order can
// change it.  The output is (float)acc * (scale_x * scale_w[n]), one f32
// product as the reference's dequant row, then the activation.  The ragged
// M and N edges are masked.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxOutputs = 8;          // outputs a thread at most
constexpr int kStage = 4;               // codes a thread quantizes a staging round
constexpr int kMaxCodes = 48 * 1024;    // staged codes a CTA, one byte each

// kOutputs: the outputs a thread owns, the launcher's least power of two
// that covers the tile, so a one-output tile runs no loop over others
template <int kOutputs, typename TX, typename TW, typename TO>
__global__ void __launch_bounds__(kThreads)
vpe_mm_q_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                float scale_x, const float* __restrict__ scale_w,
                TO* __restrict__ out, int m, int k, int n, int act,
                int bm, int bn, int bk) {
  extern __shared__ int8_t codes[];
  const int8_t* xs = codes;            // (bm, bk)
  const int8_t* ws = codes + bm * bk;  // (bk, bn)
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * bm, col0 = blockIdx.y * bn;
  const int rows = min(bm, m - row0), cols = min(bn, n - col0);
  // the outputs this thread owns, tid + j * kThreads in the tile: one
  // division here, then steps of (dr, dc) with a carry
  int r[kOutputs], c[kOutputs];
  r[0] = tid / bn;
  c[0] = tid - r[0] * bn;
  const int dr = kThreads / bn, dc = kThreads - dr * bn;
#pragma unroll
  for (int j = 1; j < kOutputs; ++j) {
    c[j] = c[j - 1] + dc;
    r[j] = r[j - 1] + dr + (c[j] >= bn);
    c[j] -= c[j] >= bn ? bn : 0;
  }
  // the outputs' weight scales, read unconditionally (a clamped column) so
  // no read waits for its use before the codes' reads are issued
  float sw[kOutputs];
  int acc[kOutputs];
#pragma unroll
  for (int j = 0; j < kOutputs; ++j) {
    acc[j] = 0;
    sw[j] = scale_w[col0 + min(c[j], cols - 1)];
  }

  for (int k0 = 0; k0 < k; k0 += bk) {
    const int kc = min(bk, k - k0);
    const int nx = rows * kc, total = nx + kc * cols;
    // stage the step's codes, kStage a thread a round: all reads first (past
    // the end a thread reads the last element again), then the quantizes
    for (int i0 = 0; i0 < total; i0 += kStage * kThreads) {
      float v[kStage], sv[kStage];
      int at[kStage];
#pragma unroll
      for (int e = 0; e < kStage; ++e) {
        if (i0 + e * kThreads >= total) break;
        const int i = min(i0 + e * kThreads + tid, total - 1);
        if (i < nx) {
          const int rr = i / kc, kk = i - rr * kc;
          v[e] = octo::to_f32(x[static_cast<int64_t>(row0 + rr) * k + k0 + kk]);
          sv[e] = scale_x;
          at[e] = rr * bk + kk;
        } else {
          const int kk = (i - nx) / cols, cc = i - nx - kk * cols;
          v[e] = octo::to_f32(w[static_cast<int64_t>(k0 + kk) * n + col0 + cc]);
          sv[e] = scale_w[col0 + cc];
          at[e] = bm * bk + kk * bn + cc;
        }
      }
#pragma unroll
      for (int e = 0; e < kStage; ++e) {
        if (i0 + e * kThreads >= total) break;
        if (i0 + e * kThreads + tid < total) {
          codes[at[e]] = static_cast<int8_t>(octo::quantize_code(v[e], sv[e]));
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kOutputs; ++j) {
      if (r[j] < rows && c[j] < cols) {
        const int8_t* xr = xs + r[j] * bk;
        const int8_t* wc = ws + c[j];
        int sum = 0;
#pragma unroll 4
        for (int kk = 0; kk < kc; ++kk) sum += xr[kk] * wc[kk * bn];
        acc[j] += sum;
      }
    }
    if (k0 + bk < k) __syncthreads();  // the next step overwrites the codes
  }
#pragma unroll
  for (int j = 0; j < kOutputs; ++j) {
    if (r[j] < rows && c[j] < cols) {
      octo::put(out + static_cast<int64_t>(row0 + r[j]) * n + col0 + c[j],
                octo::activate(static_cast<float>(acc[j]) * (scale_x * sw[j]), act));
    }
  }
}

template <typename TX, typename TW, typename TO>
cudaError_t launch(const void* x, const void* w, float scale_x, const float* scale_w, void* out,
                   int m, int k, int n, int act, int bm, int bn, int bk, cudaStream_t s) {
  const dim3 grid((m + bm - 1) / bm, (n + bn - 1) / bn);
  const int outputs = (bm * bn + kThreads - 1) / kThreads;
  auto kernel = outputs <= 1 ? vpe_mm_q_kernel<1, TX, TW, TO>
              : outputs <= 2 ? vpe_mm_q_kernel<2, TX, TW, TO>
              : outputs <= 4 ? vpe_mm_q_kernel<4, TX, TW, TO>
                             : vpe_mm_q_kernel<kMaxOutputs, TX, TW, TO>;
  kernel<<<grid, kThreads, (bm + bn) * bk, s>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), scale_x, scale_w,
      static_cast<TO*>(out), m, k, n, act, bm, bn, bk);
  return cudaSuccess;
}

}  // namespace

// bm, bn, bk come from vpe_q_plan; a tile with more outputs than the CTA's
// threads hold or more codes than kMaxCodes is refused, and so is an unknown
// dtype code of x, w or out (octo::Dtype, each f32 or bf16: all eight pairs
// are built).
extern "C" int vpe_mm_q_launch(const void* x, const void* w, float scale_x,
                               const void* scale_w, void* out, int m, int k,
                               int n, int act, int bm, int bn, int bk, int x_dtype,
                               int w_dtype, int out_dtype, void* stream) {
  if (m < 1 || k < 0 || n < 1 || bm < 1 || bn < 1 || bk < 1 ||
      static_cast<int64_t>(bm) * bn > kThreads * kMaxOutputs ||
      (static_cast<int64_t>(bm) + bn) * bk > kMaxCodes || (n + bn - 1) / bn > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err =
      octo::with_dtypes(x_dtype, w_dtype, out_dtype, [&](auto tx, auto tw, auto to) {
        return launch<typename decltype(tx)::type, typename decltype(tw)::type,
                      typename decltype(to)::type>(
            x, w, scale_x, static_cast<const float*>(scale_w), out, m, k, n, act, bm, bn, bk,
            static_cast<cudaStream_t>(stream));
      });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
