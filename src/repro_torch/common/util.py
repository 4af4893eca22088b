"""Small helpers shared across the port: shape math, device choice, segment
ranks and the engines' activations."""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

Device = Union[str, torch.device, None]

ACTIVATIONS = {"none": 0, "relu": 1, "silu": 2, "gelu": 3}  # codes of csrc/common.cuh


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
