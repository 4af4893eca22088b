"""The port's hand-written CUDA kernels, one module each, with their plain
PyTorch twins.  A wrapper runs the plain version for a CPU tensor and the
kernel for a CUDA tensor; :data:`KERNELS` holds each kernel's launch count."""
from repro_torch.kernels.arype_matmul.ops import MM_FUSED
from repro_torch.kernels.flow_features.ops import FLOW_UPDATE
from repro_torch.kernels.vpe_smallmm.ops import VPE_MM

KERNELS = {"flow_update": FLOW_UPDATE, "vpe_mm": VPE_MM, "mm_fused": MM_FUSED}


def reset_launches() -> None:
    for kernel in KERNELS.values():
        kernel.launches = 0


def launches() -> dict[str, int]:
    return {name: kernel.launches for name, kernel in KERNELS.items()}
