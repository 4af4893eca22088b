"""Conversions between the JAX package's data, seen through numpy, and the
port's tensors.

Parameters arrive as dicts of arrays (``{name: np.asarray(leaf)}``) and leave
as dicts of f32 tensors.  Tracker states and packet batches convert leaf by
leaf in field order, so a reference ``TrackerState`` passes through
``[np.asarray(x) for x in state]``.  Int8 scale tables arrive as the
reference's ``QuantScales.to_dict()`` (also the ``quant_scales`` block of its
calibration artifact).
"""
from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np
import torch

from repro_torch.common.util import Device, resolve_device
from repro_torch.core.flow_tracker import PacketBatch, TrackerState
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


def packet_batch_from_numpy(leaves: Iterable, *, device: Device = None) -> PacketBatch:
    return PacketBatch(*_leaves(leaves, device))


def to_numpy(tup) -> tuple[np.ndarray, ...]:
    """A NamedTuple of tensors (state, batch, drain result) as numpy leaves."""
    return tuple(leaf.cpu().numpy() for leaf in tup)
