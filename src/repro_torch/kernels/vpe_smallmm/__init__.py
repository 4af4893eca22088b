from repro_torch.kernels.vpe_smallmm.ops import VPE_MM, vpe_matmul, vpe_mm
