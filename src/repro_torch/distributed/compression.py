"""Int8 gradient compression with error feedback (the reference's
``distributed/compression.py``): each leaf quantized to int8 on a per-tensor
scale ``max|g| / 127`` and dequantized, so a step sees what a compressed
gradient exchange would deliver.  ``torch.round`` rounds half to even, as
``jnp.round`` does.

:func:`compressed_psum_with_feedback` is the explicit collective: each rank
quantizes ``g + e`` to int8, dequantizes it, all-reduces the dequantized
payload over one mesh axis's process group and divides by the group's size,
and keeps its own residual ``g + e - dequantized`` for the next step."""
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


def compressed_psum_with_feedback(grads: Any, errors: Any, axis: str, mesh
                                  ) -> tuple[Any, Any]:
    """Per-leaf int8 quantization with error feedback, then the mean of the
    dequantized payloads over the mesh axis ``axis`` of a live
    ``DeviceMesh``.  Returns (the reduced gradients, the new residuals)."""
    from repro_torch.distributed.comm import all_reduce, axis_size

    n = axis_size(mesh, axis)

    def one(g, e):
        gf = g.float() + e
        deq = decode_int8(encode_int8(gf))
        new_e = gf - deq  # this rank's residual, carried to its next step
        return all_reduce(deq.clone(), (axis,), mesh) / n, new_e

    out = tree_map(one, grads, errors)
    pair = lambda x: isinstance(x, tuple) and not hasattr(x, "_fields") and len(x) == 2 \
        and isinstance(x[0], torch.Tensor)
    return (tree_map(lambda t: t[0], out, is_leaf=pair),
            tree_map(lambda t: t[1], out, is_leaf=pair))


def init_error_feedback(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
