// Shared device helpers of the port's matmul kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace octo {

// Element types of the kernels' operands (x and w) and outputs: f32, or bf16
// held as its raw bits (bf16_bits) on the way in and as __nv_bfloat16 on the
// way out.  A launcher takes each as a dtype code (kF32 or kBF16).
enum Dtype : int { kF32 = 0, kBF16 = 1 };
using bf16_bits = uint16_t;

// A loaded element as f32: exact for bf16, whose 8 significand bits are the
// top half of an f32's.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16_bits v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// A type as a value, for the dispatchers below: f(Type<float>{}) and the like.
template <typename T>
struct Type {
  using type = T;
};

// f(Type<T>{}) for an operand's dtype code, T float or bf16_bits; another
// code is refused with cudaErrorInvalidValue.
template <typename F>
cudaError_t with_type(int code, F f) {
  if (code == kF32) return f(Type<float>{});
  if (code == kBF16) return f(Type<bf16_bits>{});
  return cudaErrorInvalidValue;
}

// f(Type<TX>{}, Type<TW>{}) for the dtype codes of x and w.
template <typename F>
cudaError_t with_inputs(int x_dtype, int w_dtype, F f) {
  return with_type(x_dtype, [&](auto tx) {
    return with_type(w_dtype, [&](auto tw) { return f(tx, tw); });
  });
}

// f(Type<TX>{}, Type<TW>{}, Type<TO>{}): with_inputs and the output's code,
// TO float or __nv_bfloat16.  All eight (x, w, out) pairs of types are built.
template <typename F>
cudaError_t with_dtypes(int x_dtype, int w_dtype, int out_dtype, F f) {
  return with_inputs(x_dtype, w_dtype, [&](auto tx, auto tw) -> cudaError_t {
    if (out_dtype == kF32) return f(tx, tw, Type<float>{});
    if (out_dtype == kBF16) return f(tx, tw, Type<__nv_bfloat16>{});
    return cudaErrorInvalidValue;
  });
}

// An f32 result stored as the output's type: bf16 rounded once, to nearest
// even (__float2bfloat16_rn), as torch's .to(torch.bfloat16) and XLA's astype
// round.  put2 stores the (even, odd) column pair at p as one 8- or 4-byte word.
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void put2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Activation codes shared with the Python wrappers (ACTIVATIONS in
// kernels/vpe_smallmm/ops.py).
enum Activation : int { kNone = 0, kRelu = 1, kSilu = 2, kGelu = 3 };

// gelu is the tanh form: jax.nn.gelu defaults to approximate=True, which the
// reference kernels call (vpe_smallmm.py, arype_matmul.py).
__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kRelu:
      return fmaxf(v, 0.f);
    case kSilu:
      return v * (1.f / (1.f + expf(-v)));
    case kGelu: {
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
    }
    default:
      return v;
  }
}

// Symmetric int8 code of v on scale s, as the reference's quantize_i8:
// IEEE f32 division (never a reciprocal multiply, never __fdividef), rounding
// half to even (rintf, as jnp.round; roundf would round half away from
// zero), then the clip to [-127, 127].
__device__ __forceinline__ int quantize_code(float v, float s) {
  const float q = rintf(__fdiv_rn(v, s));
  return static_cast<int>(fminf(fmaxf(q, -127.f), 127.f));
}

}  // namespace octo
