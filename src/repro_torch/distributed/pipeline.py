"""GPipe-style pipeline parallelism over one mesh axis (the reference's
``distributed/pipeline.py``), with point-to-point hand-offs between ranks.

Across pods the links are slowest, so the pod axis prefers pipeline
transfers (one activation a microbatch, point to point) over data-parallel
all-reduces of whole gradients.  The schedule:

  * the layer stack splits into ``num_stages`` contiguous groups
    (:func:`split_stages`), stage ``s`` on the axis's rank ``s``;
  * ``num_micro + num_stages - 1`` slots: at slot ``t`` stage ``s`` takes
    microbatch ``t - s`` (stage 0 from the input stream, the others from
    the previous stage's hand-off) and sends its output to the next stage;
    the (stages - 1) warmup and drain slots are the GPipe bubble, where a
    stage has no microbatch and computes nothing;
  * the last stage's outputs are broadcast along the axis.

``stage_fn(stage_params, x, stage_idx)`` is user code (usually a slice of
the superblocks) and must keep ``x``'s shape and type.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.common.tree import tree_map
from repro_torch.distributed import comm


def pipeline_forward(stage_fn: Callable[[Any, torch.Tensor, int], torch.Tensor],
                     stage_params: Any, x_microbatches: torch.Tensor, *, mesh,
                     axis: str = "pod") -> torch.Tensor:
    """Run the GPipe forward schedule over the mesh axis ``axis``.

    ``stage_params`` is this rank's stage (its leaves without the stage dim);
    ``x_microbatches`` (num_micro, mb, ...) is the input stream, the same on
    every rank.  Returns (num_micro, mb, ...) activations after every stage,
    on every rank of the axis."""
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)  # global ranks in stage order
    num_stages = len(ranks)
    stage = ranks.index(dist.get_rank())
    num_micro = x_microbatches.shape[0]
    outputs = torch.zeros_like(x_microbatches)
    for t in range(num_micro + num_stages - 1):
        m = t - stage
        if not 0 <= m < num_micro:  # a bubble slot
            continue
        x = x_microbatches[m] if stage == 0 else comm.recv(x_microbatches[0],
                                                           ranks[stage - 1])
        out = stage_fn(stage_params, x, stage)
        if stage + 1 < num_stages:
            comm.send(out, ranks[stage + 1])
        else:
            outputs[m] = out
    return comm.broadcast(outputs, ranks[-1], group=group)


def split_stages(stacked_params: Any, num_stages: int) -> Any:
    """A [num_layers, ...] stacked tree as [num_stages, layers_per_stage, ...]
    (views)."""

    def one(p):
        n = p.shape[0]
        if n % num_stages:
            raise ValueError(f"{n} layers do not split into {num_stages} stages")
        return p.reshape(num_stages, n // num_stages, *p.shape[1:])

    return tree_map(one, stacked_params)


def stage_of(split_params: Any, stage: int) -> Any:
    """Stage ``stage``'s leaves of a :func:`split_stages` tree."""
    return tree_map(lambda p: p[stage], split_params)
