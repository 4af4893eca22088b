from repro_torch.kernels.arype_matmul.ops import MM_FUSED, arype_matmul, mm_fused
