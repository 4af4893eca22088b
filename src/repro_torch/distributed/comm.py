"""Process groups and collectives of the port's distribution layer.

Backends: ranks on their own cards use NCCL; gloo serves the CPU and ranks
that share a card (NCCL refuses two ranks on one GPU).  :func:`backend_for`
chooses from the number of ranks against the visible cards, and nothing
falls back from one to the other.  gloo covers fewer collectives for CUDA
tensors (and its send/recv is CPU-only), so under gloo every collective and
hand-off of a CUDA tensor is staged through the host, in :func:`_staged`
alone; the computation stays on the card.

Collectives run over the axes of a live ``DeviceMesh`` (one process group a
mesh dim): :func:`all_gather` concatenates a dim sharded over axes (a0, a1,
...) back to its whole, :func:`all_reduce` sums over axes, :func:`relayout`
moves a block from one spec to another, and :func:`send`/:func:`recv`/
:func:`broadcast` are the GPipe schedule's.

:func:`run_world` starts ``world`` ranks with ``torch.multiprocessing``
(spawn: each rank imports the port fresh), each with its process group on
``tcp://localhost:<free port>``, and returns what rank 0's function returned.
"""
from __future__ import annotations

import os
import socket
import tempfile
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import Spec, local_slices, mesh_coordinate
from repro_torch.launch.mesh import mesh_shape


def backend_for(world: int, device_type: str) -> str:
    """NCCL when every rank has a card of its own, else gloo (the CPU, or
    ranks sharing cards)."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: cannot start ranks on the card")
        return "nccl" if world <= torch.cuda.device_count() else "gloo"
    if device_type != "cpu":
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    return "gloo"


def rank_device(rank: int, device_type: str) -> torch.device:
    """A rank's device: card ``rank`` modulo the visible cards, or the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def _staged(t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend() == "gloo"


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _gather_one(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    if n == 1:
        return t
    src = t.contiguous()
    if _staged(src):
        host = src.cpu()
        parts = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=group)
        return torch.cat(parts, dim=dim).to(t.device)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def all_gather(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole leaf from this rank's block under ``spec``: each sharded dim
    gathered over its axes, the minor axis first."""
    for dim, entry in enumerate(spec):
        for axis in reversed(_axes(entry)):
            t = _gather_one(t, dim, mesh.get_group(axis))
    return t


def all_reduce(t: torch.Tensor, axes: Optional[Sequence[str]] = None, mesh=None
               ) -> torch.Tensor:
    """``t`` summed over the mesh axes ``axes``, or over every rank of the
    world without them (in place where it can be)."""
    for group in [None] if axes is None else [mesh.get_group(axis) for axis in axes]:
        if dist.get_world_size(group) == 1:
            continue
        if _staged(t):
            host = t.cpu()
            dist.all_reduce(host, group=group)
            t = host.to(t.device)
        else:
            dist.all_reduce(t, group=group)
    return t


def block_of(full: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of a whole leaf (a view)."""
    return full[local_slices(full.shape, spec, mesh, mesh_coordinate(mesh))]


def relayout(t: torch.Tensor, shape: Sequence[int], src: Spec, dst: Spec, mesh) -> torch.Tensor:
    """This rank's block under ``dst`` from its block under ``src`` (itself
    when the specs agree)."""
    if tuple(src) == tuple(dst):
        return t
    full = all_gather(t, src, mesh)
    assert tuple(full.shape) == tuple(shape), (full.shape, shape)
    return block_of(full, dst, mesh).contiguous()


def send(t: torch.Tensor, dst: int) -> None:
    if _staged(t):
        dist.send(t.cpu(), dst)
    else:
        dist.send(t.contiguous(), dst)


def recv(like: torch.Tensor, src: int) -> torch.Tensor:
    if _staged(like):
        host = torch.empty(like.shape, dtype=like.dtype)
        dist.recv(host, src)
        return host.to(like.device)
    out = torch.empty_like(like)
    dist.recv(out, src)
    return out


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    if _staged(t):
        host = t.cpu()
        dist.broadcast(host, src, group=group)
        return host.to(t.device)
    t = t.contiguous()
    dist.broadcast(t, src, group=group)
    return t


def axis_size(mesh, axes) -> int:
    sizes = mesh_shape(mesh)
    n = 1
    for a in _axes(axes):
        n *= sizes[a]
    return n


# ---------------------------------------------------------------- starting ranks


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_rank(rank: int, world: int, port: int, device_type: str) -> tuple[str, torch.device]:
    """This process's group on ``tcp://localhost:port`` (the backend from
    :func:`backend_for`) and its device (made current on the card)."""
    backend = backend_for(world, device_type)
    device = rank_device(rank, device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, **kw)
    return backend, device


def _rank_main(rank: int, world: int, port: int, device_type: str, fn: Callable, args: tuple,
               out_dir: str) -> None:
    init_rank(rank, world, port, device_type)
    try:
        result = fn(rank, world, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_world(fn: Callable, world: int, *args, device_type: str = "cpu",
              all_ranks: bool = False, out_dir: Optional[str] = None):
    """Run ``fn(rank, world, *args)`` on ``world`` spawned ranks, each in its
    process group, and return rank 0's result (every rank's, in rank order,
    with ``all_ranks``).  ``fn`` must be importable by name (a module-level
    function) and its results loadable by ``torch.load``.  Build the CUDA
    kernels before calling, so that no two ranks compile them."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        mp.spawn(_rank_main, args=(world, free_port(), device_type, fn, args, tmp),
                 nprocs=world, join=True)
        results = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                   for r in range(world if all_ranks else 1)]
    return results if all_ranks else results[0]
