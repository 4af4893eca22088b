"""Int8 gradient compression (the reference's ``distributed/compression.py``,
the part the train step uses): each leaf quantized to int8 on a per-tensor
scale ``max|g| / 127`` and dequantized, so a step sees what a compressed
gradient exchange would deliver.  ``torch.round`` rounds half to even, as
``jnp.round`` does.  The collective with error feedback
(``compressed_psum_with_feedback``) waits for the port's mesh (ROADMAP
Queue 1 item 12)."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.common.tree import tree_map


class CompressedGrad(NamedTuple):
    q: torch.Tensor  # int8 payload
    scale: torch.Tensor  # () f32


def encode_int8(g: torch.Tensor) -> CompressedGrad:
    gf = g.float()
    scale = torch.clamp_min(torch.max(torch.abs(gf)), 1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return CompressedGrad(q=q, scale=scale)


def decode_int8(c: CompressedGrad) -> torch.Tensor:
    return c.q.float() * c.scale


def compress_tree(grads: Any) -> Any:
    return tree_map(encode_int8, grads)


def decompress_tree(comp: Any) -> Any:
    """The inverse of :func:`compress_tree`: each ``CompressedGrad`` decoded."""
    return tree_map(decode_int8, comp, is_leaf=lambda x: isinstance(x, CompressedGrad))
