"""Gather, then compute: the sharded train step's parameters.

Each rank stores only its block of every leaf (the sharding rules' spec).
A hand-written kernel never sees a ``DTensor``, so the step gathers a leaf
whole just before its use and every product runs the port's kernels on full
local operands:

  * :class:`GatherDict` is the parameter tree the model reads: indexing it
    gathers a leaf (:class:`Gather`: an all-gather over the leaf's mesh axes)
    or returns a nested :class:`GatherDict`; ``superblocks(n)`` hands the
    model each superblock's leaves (views of the stacked blocks) to gather
    at their use, so at most a superblock's parameters are whole at once;
  * :class:`Gather`'s backward all-reduces the whole gradient over the
    world, divides it by the world's size (the mean over the data-parallel
    ranks; tensor-parallel peers compute the same rows) and keeps this
    rank's block;
  * :func:`regather_saved`: while it is active, autograd saves a gathered
    leaf as a token of its block, and the backward gathers it again when it
    needs it, so a superblock's whole parameters are freed after its
    forward and after its backward.

Every rank runs the same graph, so the collectives of the forward, of the
gradients and of the saved leaves come in the same order on every rank.
"""
from __future__ import annotations

import weakref
from contextlib import contextmanager
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.distributed import comm
from repro_torch.distributed.sharding import Spec


def _whole(local: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole leaf in storage of its own (a copy where nothing was
    gathered)."""
    full = comm.all_gather(local, spec, mesh)
    if full.untyped_storage().data_ptr() == local.untyped_storage().data_ptr():
        full = full.clone()
    return full


# storage address of a live gathered leaf -> (a weak reference to it, its block, spec, mesh)
_GATHERED: dict[int, tuple] = {}


class Gather(torch.autograd.Function):
    """This rank's block -> the whole leaf; the gradient back to the block
    as the mean over the ranks."""

    @staticmethod
    def forward(ctx, local: torch.Tensor, spec: Spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        full = _whole(local.detach(), spec, mesh)
        ptr = full.untyped_storage().data_ptr()
        _GATHERED[ptr] = (weakref.ref(full), local.detach(), spec, mesh)
        weakref.finalize(full, _GATHERED.pop, ptr, None)
        return full

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        world = dist.get_world_size()
        g = comm.all_reduce(g.contiguous())
        if world > 1:
            g = g / world
        return comm.block_of(g, ctx.spec, ctx.mesh), None, None


class _Saved:
    __slots__ = ("local", "spec", "mesh", "shape", "stride", "offset")

    def __init__(self, local, spec, mesh, t: torch.Tensor):
        self.local, self.spec, self.mesh = local, spec, mesh
        self.shape, self.stride, self.offset = t.shape, t.stride(), t.storage_offset()


def _pack(t: torch.Tensor):
    entry = _GATHERED.get(t.untyped_storage().data_ptr())
    if entry is None:
        return t
    ref, local, spec, mesh = entry
    full = ref()
    if full is None or full.dtype != t.dtype:
        return t
    return _Saved(local, spec, mesh, t)


def _unpack(saved):
    if not isinstance(saved, _Saved):
        return saved
    full = _whole(saved.local, saved.spec, saved.mesh)
    return full.as_strided(saved.shape, saved.stride, saved.offset)


@contextmanager
def regather_saved():
    """Save gathered leaves as their blocks; gather them again in the
    backward."""
    with torch.autograd.graph.saved_tensors_hooks(_pack, _unpack):
        yield


class GatherDict(dict):
    """A parameter tree of blocks that gathers a leaf whenever the model
    reads it (``specs`` is the tree of its specs, ``mesh`` a live
    ``DeviceMesh``)."""

    def __init__(self, local: dict, specs: dict, mesh):
        super().__init__(local)
        self.specs, self.mesh = specs, mesh

    def __getitem__(self, key):
        v = super().__getitem__(key)
        if isinstance(v, dict):
            return GatherDict(v, self.specs[key], self.mesh)
        return Gather.apply(v, self.specs[key], self.mesh)

    def get(self, key, default=None):
        return self[key] if key in self else default

    def superblocks(self, n: int) -> list:
        """The ``n`` superblocks of ``blocks``: each a :class:`GatherDict` of
        views of the stacked blocks (the stacking dim is never sharded)."""
        def unstack(tree: dict) -> list:
            flat = {k: unstack(v) if isinstance(v, dict) else torch.unbind(v)
                    for k, v in tree.items()}
            return [{k: v[i] for k, v in flat.items()} for i in range(n)]

        def inner(specs: Any) -> Any:
            if isinstance(specs, dict):
                return {k: inner(v) for k, v in specs.items()}
            assert not specs or specs[0] is None, specs
            return tuple(specs[1:])

        blocks, specs = dict.__getitem__(self, "blocks"), inner(self.specs["blocks"])
        return [GatherDict(b, specs, self.mesh) for b in unstack(blocks)]
