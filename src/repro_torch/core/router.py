"""The Octopus placement router (paper §2.3, §3.2.3).

Every engine matmul of the port goes through :func:`matmul`, which evaluates
the utilization model on the operand shapes and runs the product on one of
the two engines:

  * **AryPE** — the blocked matmul (``kernels/arype_matmul``), the
    throughput engine;
  * **VPE** — broadcast-multiply + reduce (``kernels/vpe_smallmm``), the
    latency engine for shapes that would under-fill the systolic array.

Each engine is a hand-written CUDA kernel on the card and its plain PyTorch
twin on the CPU, chosen by the device of the operands.  x is f32 (the
pipelines) or bf16 (the LM's compute type), w f32 or bf16 (the LM's
``param_dtype``); both engines sum in f32 and round once to ``out_dtype``,
x's dtype unless the caller names another, as the reference's ``out_dtype
or x.dtype``.  With ``RuntimeConfig.quantize`` and a scale entry for the
layer, the engine runs its int8 kernel (``vpe_mm_q`` / ``mm_fused_q``)
instead, into the same ``out_dtype``.  On ``meta`` tensors
(:meth:`repro_torch.runtime.plan.RoutePlan.trace`) the route is recorded and
nothing runs.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.arype_matmul.ops import arype_matmul, arype_matmul_q
from repro_torch.kernels.vpe_smallmm.ops import vpe_matmul, vpe_matmul_q
from repro_torch.runtime.config import RuntimeConfig
from repro_torch.runtime.quant import maybe_record
from repro_torch.runtime.routing import Route, current_scope, route_matmul

__all__ = ["Route", "matmul", "route_matmul"]


def matmul(x: torch.Tensor, w: torch.Tensor, *, activation: Optional[str] = None,
           out_dtype: Optional[torch.dtype] = None, config: Optional[RuntimeConfig] = None,
           name: Optional[str] = None, route: Optional[Route] = None) -> torch.Tensor:
    """Routed matmul: x (..., M, K) @ w (K, N) -> (..., M, N) of ``out_dtype``
    (x's dtype by default).

    The batch dimensions fold into M before routing, so the placement sees
    the product the engine really runs.  Under a
    :func:`repro_torch.runtime.record_scales` block the operands' max-abs
    statistics are recorded first (the calibration tap).  With
    ``config.quantize``, a layer ``name`` that has an entry in
    ``config.quant_scales`` runs on int8 operands with int32 accumulation,
    dequantized to f32 before the activation and rounded once to
    ``out_dtype``, as the reference passes it to its int8 wrappers; other
    layers stay on the f32-accumulating engines.

    ``route`` executes a pre-decided :class:`Route` (a plan step) instead of
    deriving and recording one.  On ``meta`` operands the route is recorded
    and an empty ``meta`` result returned: no launch, no scale statistics."""
    cfg = config if config is not None else RuntimeConfig()
    *batch, m, k = x.shape
    if w.shape[0] != k:
        raise ValueError(f"matmul: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    n = w.shape[1]
    out_dtype = out_dtype or x.dtype
    meta = x.device.type == "meta"
    if not meta:
        maybe_record(name, x, w)
    qscales = (cfg.quant_scales.lookup(name, current_scope())
               if cfg.quantize and cfg.quant_scales is not None else None)
    r = route if route is not None else route_matmul(
        math.prod(batch) * m, k, n, config=cfg, name=name, quantized=qscales is not None)
    if meta:
        return torch.empty((*batch, m, n), dtype=out_dtype, device="meta")
    x2, w2, act = x.reshape(-1, k).contiguous(), w.contiguous(), activation or "none"
    if qscales is not None:
        engine = vpe_matmul_q if r.path == "vpe" else arype_matmul_q
        out = engine(x2, w2, scale_x=qscales[0], scale_w=qscales[1], activation=act,
                     out_dtype=out_dtype)
    else:
        engine = vpe_matmul if r.path == "vpe" else arype_matmul
        out = engine(x2, w2, activation=act, out_dtype=out_dtype)
    return out.reshape(*batch, m, n)
