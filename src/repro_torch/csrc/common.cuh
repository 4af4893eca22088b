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

}  // namespace octo
