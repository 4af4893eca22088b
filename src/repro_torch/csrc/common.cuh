// Shared device helpers of the port's matmul kernels.
#pragma once

#include <cuda_runtime.h>

namespace octo {

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
