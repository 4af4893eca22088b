"""Meshes (the reference's ``launch/mesh.py``) on ``torch.distributed``.

Single pod: 256 cards as (data=16, model=16).  Multi-pod: 512 as (pod=2,
data=16, model=16); the pod axis is the outer data-parallel or pipeline axis
(the slowest links).

Three kinds of mesh, each with ``axis_names`` and ``shape`` (an ordered
name -> size dict), which is all the sharding rules read:

  * :class:`AbstractMesh`: a description, no process group and no device (the
    rules of :mod:`repro_torch.distributed.sharding` run on it, as the
    reference's run on a ``jax.sharding.AbstractMesh``);
  * a ``torch.distributed.device_mesh.DeviceMesh`` over the live process
    group (:func:`make_production_mesh`, :func:`make_host_mesh`), one rank a
    mesh point;
  * :class:`LanesMesh`: the serving pipeline's ``lanes`` axis inside one
    process, one device a lane (:func:`make_lanes_mesh`).

Builders are functions, never module-level meshes, so importing this module
touches no device and no process group.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence

import torch

PROD_SHAPE, PROD_AXES = (16, 16), ("data", "model")
MULTI_POD_SHAPE, MULTI_POD_AXES = (2, 16, 16), ("pod", "data", "model")
LANES_AXIS = "lanes"


class AbstractMesh:
    """Axis names and sizes only, for the sharding rules."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axis_names)} differ "
                             "in rank")
        self.axis_names = tuple(axis_names)
        self.shape = OrderedDict(zip(self.axis_names, (int(s) for s in shape)))

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    def __repr__(self) -> str:
        return f"AbstractMesh({dict(self.shape)})"


class LanesMesh(AbstractMesh):
    """The ``lanes`` axis over devices of this process: lane ``i`` lives on
    ``devices[i]``.  A device may repeat (several lanes on one card, or on
    the CPU)."""

    def __init__(self, devices: Sequence[torch.device]):
        super().__init__((len(devices),), (LANES_AXIS,))
        self.devices = tuple(torch.device(d) for d in devices)


def mesh_shape(mesh) -> "OrderedDict[str, int]":
    """The ordered axis name -> size of any mesh kind (a ``DeviceMesh``
    included)."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh needs mesh_dim_names for the sharding rules")
    return OrderedDict(zip(names, (int(s) for s in mesh.mesh.shape)))


def axis_names(mesh) -> tuple[str, ...]:
    return tuple(mesh_shape(mesh))


def _device_mesh(device_type: str, shape: Sequence[int], axes: Sequence[str]):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("a DeviceMesh needs a live process group "
                           "(torch.distributed.init_process_group)")
    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() != n:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks, the world has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape, axes = (MULTI_POD_SHAPE, MULTI_POD_AXES) if multi_pod else (PROD_SHAPE, PROD_AXES)
    return _device_mesh(device_type, shape, axes)


def make_lanes_mesh(num_lanes: int, devices: Optional[Sequence] = None) -> LanesMesh:
    """1-D ``lanes`` mesh over the first ``num_lanes`` of ``devices`` (every
    visible card by default): the serving pipeline's parallel lanes (paper
    §2.2: extractor lanes over the multi-bank memory fabric).  It may use a
    subset of the devices; fewer devices than lanes raise, as the
    reference's.  A device may be named more than once (``["cpu"] * 4``,
    ``["cuda:0"] * 4``)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = list(devices)
    if num_lanes > len(devices):
        raise ValueError(f"need {num_lanes} devices for a lanes mesh, have {len(devices)}")
    return LanesMesh(devices[:num_lanes])


def make_host_mesh(data: int = 2, model: int = 4, pod: int = 0, *, device_type: str = "cpu"):
    """Small mesh over the live process group (the CPU tests' gloo worlds)."""
    if pod:
        return _device_mesh(device_type, (pod, data, model), ("pod", "data", "model"))
    return _device_mesh(device_type, (data, model), ("data", "model"))


# NVIDIA H100 SXM data-sheet figures (roofline denominators; not measurements)
PEAK_FLOPS_BF16 = 989e12  # dense bf16 tensor-core FLOP/s per card
HBM_BW = 3.35e12  # HBM3 bytes/s per card
NVLINK_BW = 900e9  # NVLink 4 bytes/s per card, both directions over its 18 links
