"""The Octopus runtime configuration (paper §2.3, §3.2.3): the placement
knobs of the routed compute core.

The port passes the config explicitly (``config=``); there is no ambient
context.  The defaults are the reference's analytic values, so placements
match the JAX package's plan exactly.  ``tau``/``vpe_max_elems`` may instead
come from a measured crossover: :meth:`RuntimeConfig.calibrated` loads a
:mod:`repro_torch.runtime.autotune` artifact, and the config then carries
the artifact's platform fingerprint in ``calibration`` (None: analytic).
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Any, Optional

from repro_torch.common.util import Device
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
    * ``calibration`` — platform fingerprint of the measured-crossover
      artifact that produced ``tau``/``vpe_max_elems`` (None: analytic).
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
    calibration: Optional[str] = None
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

    def replace(self, **overrides: Any) -> "RuntimeConfig":
        return dataclasses.replace(self, **overrides) if overrides else self

    @classmethod
    def calibrated(cls, path: Optional[str] = None, *, device: Device = None,
                   **overrides: Any) -> "RuntimeConfig":
        """A config whose ``tau``/``vpe_max_elems`` come from the measured
        crossover artifact at ``path`` (default: the cache path of
        ``device``'s backend, the card unless the caller names another; see
        :func:`repro_torch.runtime.autotune.load_calibration`, which also
        refuses an artifact measured on another backend than ``device``'s).
        Falls back to the analytic defaults, with the loader's warning, when
        no usable artifact exists; ``calibration`` is None then.

        ``quantize=True`` also needs per-layer scales in the artifact: when
        they are absent the config warns and stays f32 rather than running
        mis-scaled int8, as the reference's does."""
        from repro_torch.runtime import autotune

        calib = autotune.load_calibration(path, device=device)
        base = calib.apply(cls()) if calib is not None else cls()
        cfg = base.replace(**overrides)
        if cfg.quantize and cfg.quant_scales is None:
            warnings.warn(
                "quantize=True requested but the calibration artifact carries "
                "no quant_scales; falling back to the f32 datapath "
                "(re-run repro_torch.launch.calibrate to fit int8 scales)",
                UserWarning, stacklevel=2)
            cfg = cfg.replace(quantize=False)
        return cfg

    @classmethod
    def from_arch(cls, arch: Any) -> "RuntimeConfig":
        """The runtime of a model's ``ArchConfig``, as the reference's:
        ``policy`` from its ``router_policy`` and ``accum_dtype`` from its
        ``matmul_accum_dtype``."""
        return cls(policy=arch.router_policy, accum_dtype=arch.matmul_accum_dtype)
