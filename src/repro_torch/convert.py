"""Conversions between the JAX package's data, seen through numpy, and the
port's tensors.

Parameters arrive as dicts of arrays (``{name: np.asarray(leaf)}``) and leave
as dicts of f32 tensors.  Tracker states and packet batches convert leaf by
leaf in field order, so a reference ``TrackerState`` passes through
``[np.asarray(x) for x in state]``.
"""
from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np
import torch

from repro_torch.common.util import Device, resolve_device
from repro_torch.core.flow_tracker import PacketBatch, TrackerState


def params_from_numpy(params: Mapping[str, np.ndarray], *, device: Device = None
                      ) -> dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {name: torch.as_tensor(np.array(v, np.float32)).to(dev)
            for name, v in params.items()}


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
