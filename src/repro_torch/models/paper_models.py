"""The paper's own use-case models (§4.2), built on the routed compute core.

  * Use-case 1: packet-based MLP for intrusion detection:
      6 -> 12 -> 6 -> 3 -> 2, ReLU; input = per-packet features.
  * Use-case 2: flow-based 1D-CNN traffic classifier:
      3 conv layers {k=3, c: 1->32->32->32} with ceil max-pool stride 2
      between, flatten -> FC 128 -> linear 162; input = top-20 arrival
      intervals of a flow.
  * Use-case 3: flow-based payload transformer:
      payload matrix (15 pkts x 16 bytes), WQ/WK/WV (16,64), single-head
      self-attention, MLP 64->128->64, mean-pool -> linear classifier 162.

Every matmul goes through the Octopus router; conv layers are lowered via
img2col so the placement matches the paper's matrix-multiplication mapping
((20f,3)x(3,32), (10f,96)x(96,32), ...).  The transformer's two attention
products and its softmax are plain torch, as the reference leaves them to
XLA outside any kernel.  Parameters are dicts of f32 tensors with the
reference's names and layouts.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.common.util import Device, ceil_div, resolve_device
from repro_torch.core import router
from repro_torch.core.collaborative import _unfused
from repro_torch.runtime.config import RuntimeConfig
from repro_torch.runtime.routing import route_matmul

MLP_DIMS = (6, 12, 6, 3, 2)

CNN_SEQ = 20  # top-20 packet arrival intervals
CNN_CHANNELS = (1, 32, 32, 32)
CNN_KERNEL = 3
CNN_FC = 128
CNN_CLASSES = 162

TF_PKTS = 15
TF_BYTES = 16
TF_DK = 64
TF_MLP = 128
TF_CLASSES = 162


def mlp_apply(params: dict, x: torch.Tensor, *,
              config: Optional[RuntimeConfig] = None) -> torch.Tensor:
    """x: (P, 6) packet features -> logits (P, 2)."""
    h = x
    n = len(MLP_DIMS) - 1
    for i in range(n):
        h = router.matmul(h, params[f"w{i}"], config=config, name=f"w{i}") + params[f"b{i}"]
        if i < n - 1:
            h = torch.clamp_min(h, 0.0)
    return h


def _img2col_1d(x: torch.Tensor, k: int) -> torch.Tensor:
    """x: (..., L, C) -> (..., L, k*C) with 'same' zero padding (stride 1)."""
    pad = k // 2
    xp = F.pad(x, (0, 0, pad, pad))
    length = x.shape[-2]
    return torch.cat([xp[..., i:i + length, :] for i in range(k)], dim=-1)


def _ceil_pool(x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """Max-pool stride 2 with ceil semantics (paper: 20->10->5->3); the tail
    pads with -inf."""
    length = x.shape[-2]
    lp = ceil_div(length, stride) * stride
    xp = F.pad(x, (0, 0, 0, lp - length), value=-math.inf)
    return xp.reshape(*x.shape[:-2], lp // stride, stride, x.shape[-1]).amax(dim=-2)


def cnn_apply(params: dict, x: torch.Tensor, *,
              config: Optional[RuntimeConfig] = None) -> torch.Tensor:
    """x: (F, 20) interval vectors -> logits (F, 162).

    Under ``fused_aggregation=False`` each conv is routed first and, where it
    lands on the AryPE, runs unfused (K-block partials, then their sum; f32);
    a VPE-placed conv runs the routed f32 matmul, as in the reference."""
    cfg = config if config is not None else RuntimeConfig()
    h = x[..., :, None].float()  # (F, 20, 1)
    for i in range(len(CNN_CHANNELS) - 1):
        cols = _img2col_1d(h, CNN_KERNEL)  # (F, L, k*ci) == the paper's (w, ic*s)
        w = params[f"conv{i}"]
        if cfg.fused_aggregation:
            h = router.matmul(cols, w, config=cfg, name=f"conv{i + 1}")
        else:
            r = route_matmul(math.prod(cols.shape[:-1]), w.shape[0], w.shape[1], config=cfg,
                             name=f"conv{i + 1}", unfused=True)
            h = (_unfused(cols, w, None) if r.path == "arype"
                 else router.matmul(cols, w, config=cfg, route=r))
        h = _ceil_pool(torch.clamp_min(h + params[f"convb{i}"], 0.0))
    h = h.reshape(h.shape[0], -1)  # (F, 96)
    h = torch.clamp_min(router.matmul(h, params["fc_w"], config=cfg, name="fc")
                        + params["fc_b"], 0.0)
    return router.matmul(h, params["out_w"], config=cfg, name="linear") + params["out_b"]


def transformer_apply(params: dict, payload: torch.Tensor, *,
                      config: Optional[RuntimeConfig] = None) -> torch.Tensor:
    """payload: (F, 15, 16) normalized byte matrix -> logits (F, 162)."""
    def mm(x, name):
        return router.matmul(x, params[name], config=config, name=name)

    x = payload.float()
    q = mm(x, "wq")  # (F,15,64)   [(15,16)x(16,64)]
    k = mm(x, "wk")
    v = mm(x, "wv")
    s = torch.einsum("fqd,fkd->fqk", q, k) / math.sqrt(TF_DK)  # [(15,64)x(64,15)]
    a = torch.softmax(s, dim=-1)
    h = torch.einsum("fqk,fkd->fqd", a, v)  # [(15,15)x(15,64)]
    h = torch.clamp_min(mm(h, "mlp1") + params["mlp1_b"], 0.0)
    h = mm(h, "mlp2") + params["mlp2_b"]
    pooled = h.mean(dim=1)
    return router.matmul(pooled, params["cls_w"], config=config, name="cls") + params["cls_b"]


FLOW_APPLY = {"cnn": cnn_apply, "transformer": transformer_apply}


def _param_shapes(kind: str) -> dict[str, tuple[int, ...]]:
    if kind == "mlp":
        shapes = {}
        for i, (a, b) in enumerate(zip(MLP_DIMS[:-1], MLP_DIMS[1:])):
            shapes[f"w{i}"], shapes[f"b{i}"] = (a, b), (b,)
        return shapes
    if kind == "cnn":
        shapes = {}
        for i, (ci, co) in enumerate(zip(CNN_CHANNELS[:-1], CNN_CHANNELS[1:])):
            shapes[f"conv{i}"], shapes[f"convb{i}"] = (CNN_KERNEL * ci, co), (co,)
        flat = 3 * CNN_CHANNELS[-1]  # 20 -> 10 -> 5 -> 3 after three ceil-pools
        shapes.update(fc_w=(flat, CNN_FC), fc_b=(CNN_FC,),
                      out_w=(CNN_FC, CNN_CLASSES), out_b=(CNN_CLASSES,))
        return shapes
    if kind == "transformer":
        return dict(wq=(TF_BYTES, TF_DK), wk=(TF_BYTES, TF_DK), wv=(TF_BYTES, TF_DK),
                    mlp1=(TF_DK, TF_MLP), mlp1_b=(TF_MLP,), mlp2=(TF_MLP, TF_DK),
                    mlp2_b=(TF_DK,), cls_w=(TF_DK, TF_CLASSES), cls_b=(TF_CLASSES,))
    raise ValueError(f"kind must be 'mlp', 'cnn' or 'transformer', got {kind!r}")


def init_paper_model(kind: str, generator: torch.Generator, *,
                     device: Device = None) -> dict:
    """Random parameters for a standalone run: matrices are fan-in scaled
    normals, vectors zeros (the reference's init rule; the numbers differ
    from JAX's, which convert.py carries over when they must match)."""
    dev = resolve_device(device)
    params = {}
    for name, shape in sorted(_param_shapes(kind).items()):
        if len(shape) == 1:
            params[name] = torch.zeros(shape, device=dev)
        else:
            w = torch.randn(shape, generator=generator) / math.sqrt(shape[-2])
            params[name] = w.to(dev)
    return params
