"""Logical-axis -> mesh-axis sharding rules (DP / FSDP / TP / EP / SP), the
reference's ``distributed/sharding.py``.

Every parameter spec carries logical axis names; the rules map them onto the
production mesh axes (pod, data, model):

  batch        -> (pod, data)        data parallel (pod = outer DP axis)
  vocab        -> model              TP on embedding / lm head
  heads/kv     -> model              TP on attention projections (if divisible)
  mlp          -> model              TP on FFN
  expert       -> model              EP on MoE expert banks
  ssm_inner    -> model              TP on Mamba/mLSTM inner projections
  embed        -> fsdp axes          ZeRO-3 parameter sharding (if cfg.fsdp)
  kv_seq       -> model              SP on very long decode caches (optional)

A dimension its mesh axes do not divide is replicated (and recorded in
``report``), and no mesh axis is used twice in one spec.

The rules are pure functions of axis names and sizes: they run on any mesh of
:mod:`repro_torch.launch.mesh` (an ``AbstractMesh`` with no process group
included).  A spec is a tuple, one entry a dimension (``None``, an axis name,
or a tuple of axis names, major first) with trailing ``None``s dropped, so it
compares equal to ``tuple(PartitionSpec)`` of the reference's.  A
:class:`Sharding` pairs it with its mesh; :func:`placements` turns it into
``DTensor`` placements for a live ``DeviceMesh``, and :func:`local_slices`
names the block a mesh point holds.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import LANES_AXIS, axis_names, mesh_shape

Spec = tuple


class Sharding:
    """A spec on a mesh (the reference's ``NamedSharding``); a leaf of the
    trees below."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec: Sequence):
        self.mesh = mesh
        self.spec = _trim(list(spec))

    def __repr__(self) -> str:
        return f"Sharding({self.spec})"


def _trim(parts: list) -> Spec:
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _axes_of(entry) -> tuple:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def logical_rules(cfg: ArchConfig, mesh) -> dict[str, Any]:
    names = axis_names(mesh)
    if getattr(cfg, "moe_dp_attention", False):
        # Switch/GShard layout: no TP; dense params FSDP over (pod, data),
        # experts over model (EP), batch over every axis
        all_axes = tuple(a for a in ("pod", "data", "model") if a in names)
        return {
            "batch": all_axes,
            "vocab": "model",
            "heads": None, "kv_heads": None, "mlp": None,
            "expert": "model",
            "ssm_inner": None, "mlstm_inner": None, "mlstm_qk": None,
            "slstm_gates": None, "embed_out": None,
            "embed": tuple(a for a in ("pod", "data") if a in names),
            "layers": None, "kv_seq": None, "seq": None,
        }
    fsdp_axes = tuple(a for a in ("pod", "data") if a in names)
    return {
        "batch": tuple(a for a in ("pod", "data") if a in names) or None,
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "expert": "model",
        "ssm_inner": "model",
        "mlstm_inner": "model",
        "mlstm_qk": None,
        "slstm_gates": "model",
        "embed_out": None,
        "embed": fsdp_axes if cfg.fsdp else None,
        "layers": None,
        "kv_seq": "model" if cfg.shard_kv_seq_decode else None,
        "seq": None,
    }


def _axis_size(mesh, axes) -> int:
    shape = mesh_shape(mesh)
    n = 1
    for a in _axes_of(axes):
        n *= shape[a]
    return n


def spec_for_shape(shape: Sequence[int], logical: Sequence[Optional[str]], rules: dict,
                   mesh, report: Optional[list] = None) -> Spec:
    """The spec of one leaf: each dimension on its logical name's mesh axes,
    replicated where their size does not divide it, and no mesh axis twice."""
    parts = []
    used: set[str] = set()
    for dim, name in zip(shape, logical):
        axes = rules.get(name) if name else None
        if axes is None:
            parts.append(None)
            continue
        axes_t = tuple(a for a in _axes_of(axes) if a not in used)
        size = _axis_size(mesh, axes_t)
        if not axes_t or size <= 1:
            parts.append(None)
            continue
        if dim % size != 0:
            if report is not None:
                report.append((name, dim, axes_t, "replicated: not divisible"))
            parts.append(None)
            continue
        used.update(axes_t)
        parts.append(axes_t[0] if len(axes_t) == 1 else axes_t)
    return _trim(parts)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def shardings_for(tree_logical: Any, tree_abstract: Any, cfg: ArchConfig, mesh,
                  report: Optional[list] = None) -> Any:
    """A tree of logical-axis tuples and a tree of shaped leaves (tensors,
    ``meta`` tensors, anything with ``.shape``) -> a tree of
    :class:`Sharding`."""
    rules = logical_rules(cfg, mesh)
    return tree_map(lambda axes, leaf: Sharding(
        mesh, spec_for_shape(tuple(leaf.shape), axes, rules, mesh, report)),
        tree_logical, tree_abstract, is_leaf=_is_axes)


# ---------------------------------------------------------------- serving lanes


def lanes_spec(extra_dims: int = 0) -> Spec:
    """A lane-stacked leaf: dim 0 over ``lanes``, the rest replicated."""
    return _trim([LANES_AXIS] + [None] * extra_dims)


def lanes_shardings(mesh, tree_abstract: Any) -> Any:
    return tree_map(lambda leaf: Sharding(mesh, lanes_spec(len(leaf.shape) - 1)),
                    tree_abstract)


# ---------------------------------------------------------------- batches, optimizer, caches


def batch_spec(mesh, batch_size: int, extra_dims: int = 1, all_axes: bool = False) -> Spec:
    """The leading batch dim over (pod, data), or every axis for the pure-DP
    (moe_dp_attention) layout, when divisible."""
    names = ("pod", "data", "model") if all_axes else ("pod", "data")
    axes = tuple(a for a in names if a in axis_names(mesh))
    if axes and batch_size % _axis_size(mesh, axes) == 0:
        return _trim([axes if len(axes) > 1 else axes[0]] + [None] * extra_dims)
    return ()


def input_shardings(mesh, batch_abstract: dict, cfg: Optional[ArchConfig] = None) -> dict:
    """Shardings of a model-inputs dict: batch-sharded on the leading dim."""
    all_axes = bool(cfg and getattr(cfg, "moe_dp_attention", False))
    return {k: Sharding(mesh, batch_spec(mesh, v.shape[0], len(v.shape) - 1,
                                         all_axes=all_axes))
            for k, v in batch_abstract.items()}


def opt_shardings(param_sh: Any, params_abstract: Any, opt_abstract: Any) -> Any:
    """Optimizer-state shardings mirror the parameters'; a factored
    (Adafactor) leaf drops the factored dim's entry and gives the mesh axes
    it freed to its largest unsharded divisible dims."""
    flat_ps = tree_leaves(param_sh)  # a Sharding is a leaf
    flat_pa = tree_leaves(params_abstract)
    by_shape: dict[tuple, Sharding] = {}
    for sh, leaf in zip(flat_ps, flat_pa):
        by_shape.setdefault(tuple(leaf.shape), sh)

    def norm(sh: Sharding, ndim: int) -> list:
        return list(sh.spec) + [None] * (ndim - len(sh.spec))

    def fill_free_axes(spec: list, shape: tuple, mesh) -> list:
        used = {a for s in spec for a in _axes_of(s)}
        sizes = mesh_shape(mesh)
        free = [a for a in sizes if a not in used and sizes[a] > 1]
        order = sorted(range(len(shape)), key=lambda i: -shape[i])
        for a in free:
            for i in order:
                if spec[i] is None and shape[i] % sizes[a] == 0 and shape[i] >= sizes[a]:
                    spec[i] = a
                    break
        return spec

    def one(leaf):
        shape = tuple(leaf.shape)
        if shape in by_shape:
            return by_shape[shape]
        for pshape, sh in by_shape.items():  # a factored leaf: a param's shape less one dim
            parts = norm(sh, len(pshape))
            if len(pshape) >= 2 and shape == pshape[:-1]:  # row statistics
                return Sharding(sh.mesh, fill_free_axes(parts[:-1], shape, sh.mesh))
            if len(pshape) >= 2 and shape == pshape[:-2] + pshape[-1:]:  # column statistics
                return Sharding(sh.mesh, fill_free_axes(parts[:-2] + parts[-1:], shape,
                                                        sh.mesh))
        return Sharding(next(iter(by_shape.values())).mesh, ())  # scalars: replicated

    return tree_map(one, opt_abstract)


def cache_shardings(cache_abstract: Any, cfg: ArchConfig, mesh) -> Any:
    """Decode caches: the batch dim over (pod, data), the largest other dim
    over model when divisible.  A leaf's batch dim is dim 1 when its leading
    dim equals ``num_superblocks`` (a stacked cache; the reference's guess),
    else dim 0."""
    names = axis_names(mesh)
    axes_dp = tuple(a for a in ("pod", "data") if a in names)
    dp = _axis_size(mesh, axes_dp)
    tp = mesh_shape(mesh).get("model", 1)

    def one(leaf):
        shape = tuple(leaf.shape)
        parts: list = [None] * len(shape)
        bdim = 0
        if len(shape) >= 2 and shape[0] == cfg.num_superblocks and cfg.num_superblocks > 1:
            bdim = 1
        if bdim < len(shape) and shape[bdim] % dp == 0 and dp > 1:
            parts[bdim] = axes_dp if len(axes_dp) > 1 else axes_dp[0]
        rest = [(d, i) for i, d in enumerate(shape) if i != bdim and parts[i] is None]
        if rest and tp > 1:
            d, i = max(rest)
            if d % tp == 0 and d >= tp:
                parts[i] = "model"
        return Sharding(mesh, parts)

    return tree_map(one, cache_abstract)


# ---------------------------------------------------------------- a spec on live ranks


def placements(spec: Spec, mesh) -> list:
    """The spec as ``DTensor`` placements on a live ``DeviceMesh``: for each
    mesh dim, ``Shard(d)`` of the tensor dim it splits, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in axis_names(mesh):
        dims = [d for d, entry in enumerate(spec) if name in _axes_of(entry)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def mesh_coordinate(mesh) -> dict[str, int]:
    """This rank's coordinate on a live ``DeviceMesh``, by axis name."""
    return dict(zip(axis_names(mesh), mesh.get_coordinate()))


def local_slices(shape: Sequence[int], spec: Spec, mesh, coord: dict[str, int]) -> tuple:
    """The block of a ``shape`` leaf that mesh point ``coord`` holds under
    ``spec``: a dim over axes (a0, a1, ...) splits into their sizes'
    product of equal blocks, a0 the major index."""
    sizes = mesh_shape(mesh)
    out = []
    for d, n in enumerate(shape):
        axes = _axes_of(spec[d]) if d < len(spec) else ()
        parts, index = 1, 0
        for a in axes:
            parts *= sizes[a]
            index = index * sizes[a] + coord[a]
        block = n // parts
        out.append(slice(index * block, (index + 1) * block))
    return tuple(out)


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> tuple[int, ...]:
    return tuple(n // _axis_size(mesh, spec[d] if d < len(spec) else None)
                 for d, n in enumerate(shape))


def shard_factor(spec: Spec, mesh) -> int:
    """How many distinct blocks the spec cuts a leaf into."""
    n = 1
    for entry in spec:
        n *= _axis_size(mesh, entry)
    return n
