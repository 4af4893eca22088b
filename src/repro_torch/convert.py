"""Conversions between the JAX package's data, seen through numpy, and the
port's tensors.

Parameters arrive as dicts of arrays (``{name: np.asarray(leaf)}``) and leave
as dicts of f32 tensors.  Tracker states and packet batches convert leaf by
leaf in field order, so a reference ``TrackerState`` passes through
``[np.asarray(x) for x in state]``.  Int8 scale tables arrive as the
reference's ``QuantScales.to_dict()`` (also the ``quant_scales`` block of its
calibration artifact).  An LM's parameter tree and cache arrive as the
reference's nested dicts with numpy leaves (``jax.tree.map(np.asarray,
tree)``; a cache's NamedTuples stay NamedTuples) and keep their structure,
stacked leading axes included.  A sharded pipeline's stacked
state (tracker leaves (S, F, ...), cold leaves (S, C, ...), clocks (S,))
converts through the same functions, leaf by leaf.
"""
from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np
import torch

from repro_torch.common.util import Device, resolve_device
from repro_torch.core.cold_store import ColdState, TwoLevelState
from repro_torch.core.flow_tracker import PacketBatch, TrackerState
from repro_torch.models.transformer import CACHE_TYPES
from repro_torch.runtime.quant import QuantScales


def params_from_numpy(params: Mapping[str, np.ndarray], *, device: Device = None
                      ) -> dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {name: torch.as_tensor(np.array(v, np.float32)).to(dev)
            for name, v in params.items()}


def quant_scales_from_dict(d: Mapping) -> QuantScales:
    """The port's scale table from a reference ``QuantScales.to_dict()``, or
    from a whole reference calibration artifact (its ``quant_scales`` block);
    an artifact without scales raises."""
    if "entries" not in d:
        if not d.get("quant_scales"):
            raise ValueError("no quant_scales block: the artifact carries no int8 scales")
        d = d["quant_scales"]
    return QuantScales.from_dict(d)


def _leaves(leaves: Iterable, device: Device) -> list[torch.Tensor]:
    dev = resolve_device(device)
    return [torch.as_tensor(np.array(leaf)).to(dev) for leaf in leaves]


def tracker_state_from_numpy(leaves: Iterable, *, device: Device = None) -> TrackerState:
    return TrackerState(*_leaves(leaves, device))


def cold_state_from_numpy(leaves: Iterable, *, device: Device = None) -> ColdState:
    """A reference ``ColdState`` seen leaf by leaf (``tick`` a 0-d array)."""
    return ColdState(*_leaves(leaves, device))


def two_level_state_from_numpy(hot: Iterable, cold: Iterable, *,
                               device: Device = None) -> TwoLevelState:
    """A reference ``TwoLevelState`` from its ``hot`` and ``cold`` leaves."""
    return TwoLevelState(tracker_state_from_numpy(hot, device=device),
                         cold_state_from_numpy(cold, device=device))


def packet_batch_from_numpy(leaves: Iterable, *, device: Device = None) -> PacketBatch:
    return PacketBatch(*_leaves(leaves, device))


def to_numpy(tup) -> tuple[np.ndarray, ...]:
    """A NamedTuple of tensors (state, batch, drain result) as numpy leaves."""
    return tuple(leaf.cpu().numpy() for leaf in tup)


def _tensor(leaf, dev: torch.device) -> torch.Tensor:
    """A numpy leaf as a tensor of the same type; bf16 (ml_dtypes) goes
    through f32, which holds every bf16 value exactly."""
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(dev)


def lm_params_from_numpy(tree: Mapping, *, device: Device = None) -> dict:
    """A reference ``LM.init`` tree seen through numpy as the port's nested
    dict of tensors, leaf for leaf."""
    dev = resolve_device(device)
    return {k: lm_params_from_numpy(v, device=dev) if isinstance(v, Mapping) else _tensor(v, dev)
            for k, v in tree.items()}


def lm_cache_from_numpy(tree: Mapping, *, device: Device = None) -> dict:
    """A reference LM cache seen through numpy (``blocks``, head/tail layers,
    ``lengths``) as the port's cache.  Each layer's NamedTuple becomes the
    port's of the same name (``transformer.CACHE_TYPES``): an ``MLSTMCache``
    has three leaves, as an ``AttnCache`` has, so the leaf count cannot tell
    them apart.  A layer without a mixer keeps its ``()``; any other tuple
    raises."""
    dev = resolve_device(device)
    by_name = {t.__name__: t for t in CACHE_TYPES.values() if t is not tuple}

    def conv(v):
        if isinstance(v, Mapping):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, tuple):
            if len(v) == 0:
                return ()
            kind = by_name.get(type(v).__name__)
            if kind is None or getattr(v, "_fields", None) != kind._fields:
                raise ValueError(f"a {type(v).__name__} of {len(v)} leaves is no cache type "
                                 f"of the port ({', '.join(sorted(by_name))})")
            return kind(*(_tensor(x, dev) for x in v))
        return _tensor(v, dev)

    return conv(tree)
