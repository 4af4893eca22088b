"""Small helpers shared across the port: shape math, device choice, segment
ranks and the engines' activations."""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

Device = Union[str, torch.device, None]

ACTIVATIONS = {"none": 0, "relu": 1, "silu": 2, "gelu": 3}  # codes of csrc/common.cuh
# the engine kernels' operand and output types (octo::Dtype codes of
# csrc/common.cuh): f32, and bf16, the LM's compute and weight type
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the ROADMAP item that holds the engine arm the port does not run yet
BF16_ROADMAP = "ROADMAP Queue 2 item 1"


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return ceil_div(a, b) * b


def resolve_device(device: Device = None) -> torch.device:
    """The port runs on the card unless the caller names another device; with
    no card and no device named it refuses rather than run on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; "
                "pass device='cpu' to run its plain PyTorch versions")
        return torch.device("cuda")
    return torch.device(device)


def segment_ranks(sorted_keys: torch.Tensor) -> torch.Tensor:
    """(P,) int64 position of every element inside its run of equal keys
    (``sorted_keys`` sorted, so equal keys are adjacent)."""
    p = sorted_keys.shape[0]
    pos = torch.arange(p, device=sorted_keys.device)
    first = torch.ones(p, dtype=torch.bool, device=sorted_keys.device)
    first[1:] = sorted_keys[1:] != sorted_keys[:-1]
    start = torch.cummax(torch.where(first, pos, 0), dim=0).values
    return pos - start


def apply_activation(out: torch.Tensor, activation: Optional[str]) -> torch.Tensor:
    """The engines' activations.  gelu is the tanh form, as ``jax.nn.gelu``
    (approximate=True by default) computes it in the reference."""
    if activation in (None, "none"):
        return out
    if activation == "relu":
        return torch.clamp_min(out, 0.0)
    if activation == "silu":
        return out * torch.sigmoid(out)
    if activation == "gelu":
        return F.gelu(out, approximate="tanh")
    raise ValueError(f"activation must be one of {tuple(ACTIVATIONS)}, got {activation!r}")


def activation_vjp(z: torch.Tensor, g: torch.Tensor, activation: Optional[str]) -> torch.Tensor:
    """``g`` pulled back through the engines' activation at its f32 input
    ``z``, in f32, as ``jax.grad`` differentiates the reference's
    ``_apply_activation``: relu as ``jnp.maximum(z, 0)`` (slope 1/2 at
    z == 0), silu as ``z * sigmoid(z)`` by the product rule, gelu as the
    tanh form ``z * 0.5 * (1 + tanh(c * (z + 0.044715 z^3)))``."""
    if activation in (None, "none"):
        return g
    if activation == "relu":
        return g * torch.where(z > 0, 1.0, torch.where(z == 0, 0.5, 0.0))
    if activation == "silu":
        s = torch.sigmoid(z)
        return g * s + (g * z) * (s * (1 - s))
    if activation == "gelu":
        c = float(np.float32(np.sqrt(2 / np.pi)))
        t = torch.tanh(c * (z + 0.044715 * z ** 3))
        cdf = 0.5 * (1.0 + t)
        dcdf = 0.5 * (1 - t * t) * c * (1 + 3 * 0.044715 * z * z)
        return g * cdf + (g * z) * dcdf
    raise ValueError(f"activation must be one of {tuple(ACTIVATIONS)}, got {activation!r}")
