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

Under autograd (grad enabled and an operand that requires it) the engine
call is an :class:`EngineMatmul`, whose backward runs the engines too: the
reference trains on XLA's ``dot_general``, whose transpose sums each
cotangent product in f32 and rounds once to the operand's type, which is
what an engine computes.  With no grad required nothing changes: the same
launches give the same bits.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.common.util import activation_vjp
from repro_torch.kernels.arype_matmul.ops import arype_matmul, arype_matmul_q
from repro_torch.kernels.vpe_smallmm.ops import vpe_matmul, vpe_matmul_q
from repro_torch.runtime.config import RuntimeConfig
from repro_torch.runtime.quant import maybe_record
from repro_torch.runtime.routing import Route, current_scope, place, route_matmul

__all__ = ["EngineMatmul", "Route", "matmul", "route_matmul"]

# why no backward runs through the int8 engines
QUANT_GRAD = ("no backward through an int8 route: the reference's int8 path rounds "
              "through jnp.round, whose gradient is zero, and no int8 engine runs the "
              "transposed products (ROADMAP Queue 1, backward through int8 routes)")


def _engine(path: str):
    return vpe_matmul if path == "vpe" else arype_matmul


class EngineMatmul(torch.autograd.Function):
    """One engine matmul x (M, K) @ w (K, N) with the activation, for
    autograd.  The forward is the engine call :func:`matmul` makes.  The
    backward, each product on the engine :func:`place` picks for its own
    (M, K, N) under the forward's config:

      * the cotangent upcast to f32 (exact);
      * under an activation, z = x @ w recomputed in f32 on the forward's
        engine and the cotangent pulled back through the activation at z
        (``activation_vjp``);
      * dX = g @ w^T, rounded once to x's type; dW = x^T @ g, rounded once
        to w's type.  The engines take contiguous operands, so w^T and x^T
        are copies."""

    @staticmethod
    def forward(ctx, x, w, activation: str, out_dtype: torch.dtype, path: str,
                cfg: RuntimeConfig):
        ctx.save_for_backward(x, w)
        ctx.activation, ctx.path, ctx.cfg = activation, path, cfg
        return _engine(path)(x, w, activation=activation, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        (m, k), n = x.shape, w.shape[1]
        g = g.float()
        if ctx.activation != "none":
            z = _engine(ctx.path)(x, w, activation="none", out_dtype=torch.float32)
            g = activation_vjp(z, g, ctx.activation)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _engine(place(m, n, k, ctx.cfg).path)(g, w.t().contiguous(), out_dtype=x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _engine(place(k, m, n, ctx.cfg).path)(x.t().contiguous(), g, out_dtype=w.dtype)
        return dx, dw, None, None, None, None


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
    grad = torch.is_grad_enabled() and (x2.requires_grad or w2.requires_grad)
    if qscales is not None:
        if grad:
            raise NotImplementedError(f"matmul {name!r}: {QUANT_GRAD}")
        engine = vpe_matmul_q if r.path == "vpe" else arype_matmul_q
        out = engine(x2, w2, scale_x=qscales[0], scale_w=qscales[1], activation=act,
                     out_dtype=out_dtype)
    elif grad:
        out = EngineMatmul.apply(x2, w2, act, out_dtype, r.path, cfg)
    else:
        out = _engine(r.path)(x2, w2, activation=act, out_dtype=out_dtype)
    return out.reshape(*batch, m, n)
