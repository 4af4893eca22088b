"""The Octopus placement router (paper §2.3, §3.2.3).

Every engine matmul of the port goes through :func:`matmul`, which evaluates
the utilization model on the operand shapes and runs the product on one of
the two engines:

  * **AryPE** — the blocked matmul (``kernels/arype_matmul``), the
    throughput engine;
  * **VPE** — broadcast-multiply + reduce (``kernels/vpe_smallmm``), the
    latency engine for shapes that would under-fill the systolic array.

Each engine is a hand-written CUDA kernel on the card and its plain PyTorch
twin on the CPU, chosen by the device of the operands.  With
``RuntimeConfig.quantize`` and a scale entry for the layer, the engine runs
its int8 kernel (``vpe_mm_q`` / ``mm_fused_q``) instead.
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
           config: Optional[RuntimeConfig] = None, name: Optional[str] = None
           ) -> torch.Tensor:
    """Routed matmul: x (..., M, K) @ w (K, N) -> (..., M, N) f32.

    The batch dimensions fold into M before routing, so the placement sees
    the product the engine really runs.  Under a
    :func:`repro_torch.runtime.record_scales` block the operands' max-abs
    statistics are recorded first (the calibration tap).  With
    ``config.quantize``, a layer ``name`` that has an entry in
    ``config.quant_scales`` runs on int8 operands with int32 accumulation,
    dequantized to f32 before the activation; other layers stay f32."""
    cfg = config if config is not None else RuntimeConfig()
    *batch, m, k = x.shape
    if w.shape[0] != k:
        raise ValueError(f"matmul: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    n = w.shape[1]
    maybe_record(name, x, w)
    qscales = (cfg.quant_scales.lookup(name, current_scope())
               if cfg.quantize and cfg.quant_scales is not None else None)
    r = route_matmul(math.prod(batch) * m, k, n, config=cfg, name=name,
                     quantized=qscales is not None)
    x2, w2, act = x.reshape(-1, k).contiguous(), w.contiguous(), activation or "none"
    if qscales is not None:
        engine = vpe_matmul_q if r.path == "vpe" else arype_matmul_q
        out = engine(x2, w2, scale_x=qscales[0], scale_w=qscales[1], activation=act)
    else:
        engine = vpe_matmul if r.path == "vpe" else arype_matmul
        out = engine(x2, w2, activation=act)
    return out.reshape(*batch, m, n)
