"""The port's hand-written CUDA kernels, one module each, with their plain
PyTorch twins.  A wrapper runs the plain version for a CPU tensor and the
kernel for a CUDA tensor; :data:`KERNELS` holds each kernel's launch count,
and :func:`matmul_launches` says what a run of recorded matmuls launches."""
from repro_torch.kernels.arype_matmul.ops import (
    MM_FUSED,
    MM_FUSED_Q,
    MM_PARTIALS_SUM,
    MM_UNFUSED_PARTIALS,
)
from repro_torch.kernels.flow_features.ops import FLOW_UPDATE
from repro_torch.kernels.vpe_smallmm.ops import VPE_MM, VPE_MM_Q

KERNELS = {"flow_update": FLOW_UPDATE, "vpe_mm": VPE_MM, "mm_fused": MM_FUSED,
           "vpe_mm_q": VPE_MM_Q, "mm_fused_q": MM_FUSED_Q,
           # the unfused ablation's two passes: K-block partials, then their sum
           "mm_unfused_partials": MM_UNFUSED_PARTIALS, "mm_partials_sum": MM_PARTIALS_SUM}


def reset_launches() -> None:
    for kernel in KERNELS.values():
        kernel.launches = 0


def launches() -> dict[str, int]:
    return {name: kernel.launches for name, kernel in KERNELS.items()}


# the kernel of each engine (path) in f32 and in int8 (quantized)
_ENGINE_KERNEL = {("vpe", False): "vpe_mm", ("arype", False): "mm_fused",
                  ("vpe", True): "vpe_mm_q", ("arype", True): "mm_fused_q"}


def matmul_launches(routes, repeat: int = 1) -> dict[str, int]:
    """Launch counts, every kernel of :data:`KERNELS` included, of ``repeat``
    runs of the recorded matmuls ``routes`` (``RouteRecord``s): each launches
    its engine's f32 or int8 kernel, or, recorded ``unfused``, the partials
    pass and the sum pass."""
    want = dict.fromkeys(KERNELS, 0)
    for record in routes:
        names = (("mm_unfused_partials", "mm_partials_sum") if record.unfused
                 else (_ENGINE_KERNEL[record.route.path, record.quantized],))
        for name in names:
            want[name] += repeat
    return want
