"""The Octopus placement router (paper §2.3, §3.2.3).

Every engine matmul of the port goes through :func:`matmul`, which evaluates
the utilization model on the operand shapes and runs the product on one of
the two engines:

  * **AryPE** — the blocked matmul (``kernels/arype_matmul``), the
    throughput engine;
  * **VPE** — broadcast-multiply + reduce (``kernels/vpe_smallmm``), the
    latency engine for shapes that would under-fill the systolic array.

Each engine is a hand-written CUDA kernel on the card and its plain PyTorch
twin on the CPU, chosen by the device of the operands.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.arype_matmul.ops import arype_matmul
from repro_torch.kernels.vpe_smallmm.ops import vpe_matmul
from repro_torch.runtime.config import RuntimeConfig
from repro_torch.runtime.routing import Route, route_matmul

__all__ = ["Route", "matmul", "route_matmul"]


def matmul(x: torch.Tensor, w: torch.Tensor, *, activation: Optional[str] = None,
           config: Optional[RuntimeConfig] = None, name: Optional[str] = None
           ) -> torch.Tensor:
    """Routed matmul: x (..., M, K) @ w (K, N) -> (..., M, N) f32.

    The batch dimensions fold into M before routing, so the placement sees
    the product the engine really runs."""
    *batch, m, k = x.shape
    if w.shape[0] != k:
        raise ValueError(f"matmul: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    n = w.shape[1]
    m_eff = math.prod(batch) * m
    r = route_matmul(m_eff, k, n, config=config, name=name)
    engine = vpe_matmul if r.path == "vpe" else arype_matmul
    out = engine(x.reshape(-1, k).contiguous(), w.contiguous(),
                 activation=activation or "none")
    return out.reshape(*batch, m, n)
