"""Placement routing (paper §2.3, §3.2.3): the utilization model and the
per-matmul :class:`Route` decision.

A (M,K)x(K,N) matmul on a ``T×T`` systolic array fills ``K/⌈K⌉_T · N/⌈N⌉_T``
of the stationary tile, with an M-side penalty for streams shorter than the
array's fill depth.  While a :func:`record_routes` block is active every
decision is appended to the recorder.
"""
from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass
from typing import Iterator, List, Optional

from repro_torch.common.util import ceil_div
from repro_torch.runtime.config import RuntimeConfig


@dataclass(frozen=True)
class Route:
    path: str  # "arype" | "vpe"
    util: float
    reason: str


@dataclass(frozen=True)
class RouteRecord:
    """One recorded placement decision; ``quantized`` marks a matmul that
    runs the int8 engine path (``quantize`` on and a scale entry for it),
    ``unfused`` one that runs the AryPE without fused aggregation (K-block
    partials, then their sum)."""

    name: Optional[str]
    m: int
    k: int
    n: int
    route: Route
    quantized: bool = False
    unfused: bool = False


_recorder: ContextVar[Optional[List[RouteRecord]]] = ContextVar("route_recorder", default=None)
_name_scope: ContextVar[str] = ContextVar("route_name_scope", default="")


@contextmanager
def record_routes() -> Iterator[List[RouteRecord]]:
    """Collect every :func:`route_matmul` decision made inside the block."""
    records: List[RouteRecord] = []
    token = _recorder.set(records)
    try:
        yield records
    finally:
        _recorder.reset(token)


@contextmanager
def name_scope(label: str) -> Iterator[None]:
    """Prefix recorded matmul names with ``label/`` within the block (nesting
    joins with ``/``), so the packet and flow engines stay apart in one
    recording."""
    outer = _name_scope.get()
    token = _name_scope.set(f"{outer}{label}/")
    try:
        yield
    finally:
        _name_scope.reset(token)


def current_scope() -> str:
    """The active :func:`name_scope` prefix ("" outside any scope)."""
    return _name_scope.get()


@contextmanager
def lane_scope(lane: int) -> Iterator[None]:
    """:func:`name_scope` for one serving lane (``lane<i>/``): the sharded
    pipeline runs and traces each lane's engines under its own scope, so
    ``RoutePlan.scoped(f"lane{i}")`` holds one lane's placement."""
    with name_scope(f"lane{lane}"):
        yield


def systolic_utilization(m: int, k: int, n: int, array: int) -> float:
    """The paper's utilization definition (§3.2.3): useful MACs over
    array-slots x stream-cycles.  (10,3)x(3,32) on 32x32 gives 9.3%."""
    kb, nb = ceil_div(k, array), ceil_div(n, array)
    return (m * k * n) / (kb * nb * m * array * array)


def mxu_utilization(m: int, k: int, n: int, tile: int, fill: int) -> float:
    """Routing cost model: stationary-tile fill (K, N padding waste) times the
    granularity penalty on the streamed M dimension."""
    fill_k = k / (ceil_div(k, tile) * tile)
    fill_n = n / (ceil_div(n, tile) * tile)
    stream = m / (ceil_div(m, fill) * fill)
    return fill_k * fill_n * stream


def place(m: int, k: int, n: int, config: Optional[RuntimeConfig] = None) -> Route:
    """The engine for an (m,k)x(k,n) matmul under ``config``, recording
    nothing (the backward's products place themselves through this: autograd
    may run them on another thread, outside any :func:`record_routes`)."""
    cfg = config if config is not None else RuntimeConfig()
    util = mxu_utilization(m, k, n, tile=cfg.mxu_tile, fill=cfg.fill_depth)
    if cfg.policy == "arype_only":
        return Route("arype", util, "forced")
    if cfg.policy == "vpe_only":
        return Route("vpe", util, "forced")
    if util < cfg.tau and m * k * n <= cfg.vpe_max_elems:
        return Route("vpe", util, f"util {util:.3f} < {cfg.tau} and working set fits VPU path")
    return Route("arype", util, f"util {util:.3f}")


def route_matmul(m: int, k: int, n: int, *, config: Optional[RuntimeConfig] = None,
                 name: Optional[str] = None, quantized: bool = False,
                 unfused: bool = False) -> Route:
    """Decide the engine for an (m,k)x(k,n) matmul.  Records the decision if a
    :func:`record_routes` block is active; ``quantized`` is what the caller
    found in the scale table (``router.matmul`` passes it), ``unfused`` that
    the caller runs the product unfused should it land on the AryPE."""
    route = place(m, k, n, config)
    records = _recorder.get()
    if records is not None:
        scope = _name_scope.get()
        scoped = f"{scope}{name}" if name is not None else (scope or None)
        records.append(RouteRecord(scoped, m, k, n, route, quantized,
                                   unfused and route.path == "arype"))
    return route
