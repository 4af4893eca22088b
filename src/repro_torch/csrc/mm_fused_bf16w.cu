// mm_fused on bf16 weights (mm_fused_tf32x3.cuh), built apart from
// mm_fused.cu so that the two halves of its kernels compile in parallel.
#include "mm_fused_tf32x3.cuh"

namespace octo {

cudaError_t mm_fused_bf16w(const void* x, int x_dtype, const bf16_bits* w, void* out,
                           int out_dtype, int m, int k, int n, int act, int tile, int split,
                           cudaStream_t s) {
  return launch_on_w(x, x_dtype, w, out, out_dtype, m, k, n, act, tile, split, s);
}

}  // namespace octo
