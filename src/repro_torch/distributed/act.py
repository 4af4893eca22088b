"""Activation sharding constraints (the reference's ``distributed/act.py``):
a thread-local mesh context and ``shard_act(x, *logical_names)`` at the
reference's places in the models (the residual stream, per-head tensors,
scan carries, the MoE's dispatch buffers).

The spec is the reference's: each named dim on its rule's mesh axes, skipped
where they do not divide it, no mesh axis twice, trailing ``None``s dropped;
nothing outside a mesh or on a mesh of one point.  The port computes on
local tensors, so ``shard_act`` returns ``x`` itself.  Under a live mesh (a
``DeviceMesh``) whose context names the local batch rows (the sharded train
step's), it checks that a ``"batch"`` dim holds exactly those rows.  A
:func:`record_act` context collects every ``(logical names, spec)`` pair, on
any mesh (an ``AbstractMesh`` included).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional

import torch

from repro_torch.launch.mesh import AbstractMesh, mesh_shape

_CTX = threading.local()

# logical activation axis -> mesh axes
_ACT_RULES = {
    "batch": ("pod", "data"),
    "batch_dp": ("pod", "data"),  # always the pure-DP axes (MoE group dim)
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "expert": ("model",),
    "embed": (),  # residual stream stays replicated on the model axis
    "vocab": ("model",),
    "inner": ("model",),
    "kv_seq": ("model",),
    "seq_sp": ("model",),  # sequence-parallel residual stream
}


def rules_for(cfg=None) -> dict:
    """Activation rules, layout-aware (``ArchConfig.moe_dp_attention``)."""
    rules = dict(_ACT_RULES)
    if cfg is not None and getattr(cfg, "moe_dp_attention", False):
        rules.update(batch=("pod", "data", "model"), heads=(), kv_heads=(), mlp=(), inner=())
    return rules


@contextmanager
def use_act_sharding(mesh, cfg=None, *, local_batch: Optional[int] = None):
    """Activate ``mesh`` (``None``: no constraints) for ``shard_act``;
    ``local_batch`` is the rows of the batch this rank computes."""
    prev = getattr(_CTX, "env", None)
    _CTX.env = (mesh, rules_for(cfg), local_batch) if mesh is not None else None
    try:
        yield
    finally:
        _CTX.env = prev


@contextmanager
def record_act():
    """Collect ``(names, spec)`` of every constrained activation into the
    yielded list."""
    prev = getattr(_CTX, "record", None)
    _CTX.record = out = []
    try:
        yield out
    finally:
        _CTX.record = prev


def current_mesh():
    env = getattr(_CTX, "env", None)
    return env[0] if env else None


def act_spec(shape, names, mesh, rules) -> tuple:
    """The spec ``shard_act`` gives a ``shape`` activation."""
    sizes = mesh_shape(mesh)
    parts = []
    used: set[str] = set()
    for dim, name in zip(shape, names):
        if name is None:
            parts.append(None)
            continue
        axes = tuple(a for a in rules.get(name, ()) if a in sizes and a not in used)
        size = 1
        for a in axes:
            size *= sizes[a]
        if not axes or size <= 1 or dim % size != 0:
            parts.append(None)
            continue
        used.update(axes)
        parts.append(axes[0] if len(axes) == 1 else axes)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def shard_act(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """Constrain ``x``'s dims to the mesh axes of their logical names (None:
    replicated).  Returns ``x``."""
    env = getattr(_CTX, "env", None)
    if env is None:
        return x
    mesh, rules, local_batch = env
    size = 1
    for s in mesh_shape(mesh).values():
        size *= s
    if size == 1:
        return x
    if len(names) != x.dim():
        raise ValueError(f"shard_act: {len(names)} names for a {x.dim()}-d activation "
                         f"{tuple(x.shape)}: {names}")
    spec = act_spec(tuple(x.shape), names, mesh, rules)
    record = getattr(_CTX, "record", None)
    if record is not None:
        record.append((tuple(names), spec))
    if local_batch is not None and not isinstance(mesh, AbstractMesh):
        for d, name in enumerate(names):
            if name == "batch" and x.shape[d] != local_batch:
                raise ValueError(f"shard_act: dim {d} ('batch') of {tuple(x.shape)} holds "
                                 f"{x.shape[d]} rows, this rank computes {local_batch}")
    return x
