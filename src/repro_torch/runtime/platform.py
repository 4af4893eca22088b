"""Execution-platform probing: the port's copy of ``repro/runtime/platform.py``.

A calibration artifact records the platform it was measured on, so that a
measurement taken on one target is never applied to another.  The port asks
PyTorch about the device a caller names (the card unless the caller asks for
the CPU, as everywhere in the port).

Unlike the reference's probes, these never degrade to CPU answers: probing a
CUDA device on a host without a card raises, as ``resolve_device`` refuses
to fall back.  The reference's ``interpret_default`` and
``pallas_available`` have no counterpart: they choose Pallas's interpret
mode, while in the port the tensor's device picks the kernel.
:func:`lanes_backend` picks the sharded pipeline's lanes as the reference's
does, from the cards of ``device``'s backend.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.common.util import Device, resolve_device

BACKENDS = ("cuda", "cpu")


def _device(device: Device) -> torch.device:
    dev = resolve_device(device)
    if dev.type not in BACKENDS:
        raise ValueError(f"no platform probe for device {dev} (the port runs on {BACKENDS})")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device: cannot probe {dev}; pass device='cpu' to probe "
                           "the host")
    return dev


def backend(device: Device = None) -> str:
    """The backend of ``device``: "cuda" or "cpu"."""
    return _device(device).type


def device_kind(device: Device = None) -> str:
    """The hardware kind of ``device`` ("NVIDIA H100 80GB HBM3"; "cpu")."""
    dev = _device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def device_count(device: Device = None) -> int:
    """Number of devices of ``device``'s backend on this host (1 for the CPU)."""
    return torch.cuda.device_count() if _device(device).type == "cuda" else 1


def devices(device: Device = None) -> list[torch.device]:
    """The devices of ``device``'s backend: every card, or the host counted
    :func:`device_count` times (the lanes a mesh may span)."""
    dev = _device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(device_count(dev))]
    return [dev] * device_count(dev)


def lanes_backend(num_lanes: int, device: Device = None) -> str:
    """How the sharded pipeline runs its lanes: ``"shard_map"`` (a device a
    lane, each lane's bank on its own card) when ``1 < num_lanes <=``
    :func:`device_count`, else ``"vmap"`` (one lane-batched bank)."""
    return "shard_map" if 1 < num_lanes <= device_count(device) else "vmap"


def is_accelerator(device: Device = None) -> bool:
    """True when ``device`` is a card (not the host)."""
    return backend(device) == "cuda"


def fingerprint(device: Device = None) -> Dict[str, str]:
    """Identity of the execution platform, embedded in calibration artifacts
    so a cache written on one target is never silently applied to another."""
    return {"backend": backend(device), "device_kind": device_kind(device),
            "torch": torch.__version__}


def fingerprint_id(fp: Optional[Dict[str, str]] = None, *, device: Device = None) -> str:
    """Short one-line form of :func:`fingerprint`
    ("cuda/NVIDIA H100 80GB HBM3/torch-2.11.0+cu128")."""
    fp = fp if fp is not None else fingerprint(device)
    return f"{fp['backend']}/{fp['device_kind']}/torch-{fp['torch']}"
