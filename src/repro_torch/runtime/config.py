"""The Octopus runtime configuration (paper §2.3, §3.2.3): the placement
knobs of the routed compute core.

The port passes the config explicitly (``config=``); there is no ambient
context.  The defaults are the reference's analytic values, so placements
match the JAX package's plan exactly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from repro_torch.runtime.quant import QuantScales

POLICIES = ("collaborative", "arype_only", "vpe_only")


@dataclass(frozen=True)
class RuntimeConfig:
    """Placement + execution knobs.

    * ``policy`` — "collaborative" (router decides), "arype_only", "vpe_only".
    * ``tau`` — MXU-utilization threshold below which work routes to VPE.
    * ``mxu_tile`` — systolic array edge of the modelled hardware.
    * ``fill_depth`` — minimum stream length to hide systolic fill latency.
    * ``vpe_max_elems`` — VPE-path working-set cap (M*K*N fp32 elements).
    * ``accum_dtype`` — accumulation dtype of both engines ("float32").
    * ``fused_aggregation`` — fuse K-block partial aggregation; False is the
      paper's "wo/ collaborating" ablation: AryPE-placed matmuls of
      ``collaborative_forward`` and ``cnn_apply`` write their K-block
      partials to memory and sum them in a second pass (``mm_unfused_partials``),
      always in f32.
    * ``quantize`` — run engine matmuls on int8 operands with int32
      accumulation, dequantized to f32 before the activation; only layers
      whose name has an entry in ``quant_scales`` quantize, the rest (and
      every layer when the table is None) run the f32 path unchanged.
    * ``quant_scales`` — the per-layer :class:`QuantScales` table.
    """

    policy: str = "collaborative"
    tau: float = 0.35
    mxu_tile: int = 128
    fill_depth: int = 8
    vpe_max_elems: int = 1 << 21
    accum_dtype: str = "float32"
    fused_aggregation: bool = True
    quantize: bool = False
    quant_scales: Optional[QuantScales] = None

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, got {self.policy!r}")
        if not 0.0 < self.tau <= 1.0:
            raise ValueError(f"tau must be in (0, 1], got {self.tau}")
        if self.mxu_tile <= 0 or self.fill_depth <= 0 or self.vpe_max_elems <= 0:
            raise ValueError("mxu_tile, fill_depth and vpe_max_elems must be positive")
        if self.accum_dtype != "float32":
            raise NotImplementedError("the engine kernels accumulate in float32 only")

    @classmethod
    def from_arch(cls, arch: Any) -> "RuntimeConfig":
        """The runtime of a model's ``ArchConfig``, as the reference's:
        ``policy`` from its ``router_policy`` and ``accum_dtype`` from its
        ``matmul_accum_dtype``."""
        return cls(policy=arch.router_policy, accum_dtype=arch.matmul_accum_dtype)
