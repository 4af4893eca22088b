"""The streaming in-network serving pipeline (paper §2.3 working procedure).

One continuous loop over packet microbatches — the paper's steps 1 -> 6:

  1. parse    — ingest a :class:`PacketBatch` microbatch
  2. track    — merge it into the hash-indexed flow table: the segmented
                update (:func:`feature_extractor.segmented_update`, the
                ``flow_update`` kernel on the card) or the scan oracle
                (:func:`flow_tracker.process_packets`); both are bit-identical
  3. extract  — drain up to ``max_ready`` ready flows (count >= top_n) and
                recycle their slots (:func:`flow_tracker.drain_ready`)
  4. infer    — per-packet features -> :class:`PacketEngine` (MLP); drained
                flow series or payloads -> :class:`FlowEngine` (CNN or
                transformer), both through the routed engine kernels
  5. decide   — logits -> allow/deny + class ids
  6. feed back — decisions update the switch-facing rule table (host side)

Steps 2-5 run eagerly on the pipeline's device, one microbatch per
:meth:`OctopusPipeline.step`; the output shapes are static (``batch_size``
packets in, ``max_ready`` masked flow rows out).
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Iterable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.common.util import Device, resolve_device
from repro_torch.core import decisions
from repro_torch.core import feature_extractor as fx
from repro_torch.core import flow_tracker as ft
from repro_torch.kernels.flow_features.ops import check_program, default_program
from repro_torch.models import paper_models
from repro_torch.runtime.config import RuntimeConfig
from repro_torch.runtime.plan import RoutePlan
from repro_torch.runtime.routing import name_scope
from repro_torch.serving.packet_path import FLOW_MODELS, FlowEngine, PacketEngine

TRACKERS = ("segmented", "scan")


@dataclass(frozen=True)
class PipelineConfig:
    """Static shapes + thresholds of the streaming loop.

    ``scan_len``, ``overlap`` and ``cold_size`` name the reference's chunked
    dispatch, deferred-sync dispatch and cold store, which are not ported
    yet: they must keep their defaults."""

    batch_size: int = 32  # packets per microbatch (step granularity)
    max_ready: int = 8  # ready-flow rows drained per step
    flow_model: str = "cnn"
    table_size: int = 1024  # flow-state table depth (paper: 8192)
    top_n: int = paper_models.CNN_SEQ  # ready threshold / series depth
    top_k: int = 15  # payload rows per flow
    pay_bytes: int = 16  # payload bytes per packet
    tracker: str = "segmented"  # "segmented" (vectorized) | "scan" (oracle)
    scan_len: int = 1
    overlap: bool = False
    cold_size: int = 0
    deny_threshold: float = 0.5  # default BinaryHead packet-deny threshold
    pkt_head: Optional[Any] = None  # packet DecisionHead (None -> BinaryHead)
    flow_head: Optional[Any] = None  # flow DecisionHead (None -> ClassHead)

    def __post_init__(self):
        if self.pkt_head is None:
            object.__setattr__(self, "pkt_head", decisions.BinaryHead(self.deny_threshold))
        if self.flow_head is None:
            object.__setattr__(self, "flow_head", decisions.ClassHead())
        for role, head in (("pkt_head", self.pkt_head), ("flow_head", self.flow_head)):
            if not isinstance(head, decisions.DecisionHead):
                raise ValueError(f"{role} must implement DecisionHead "
                                 f"(name + needs_logits), got {head!r}")
        if self.scan_len != 1 or self.overlap or self.cold_size:
            raise NotImplementedError("scan_len > 1, overlap and cold_size are "
                                      "not ported yet")
        if self.flow_model not in FLOW_MODELS:
            raise ValueError(f"flow_model must be one of {FLOW_MODELS}, "
                             f"got {self.flow_model!r}")
        if self.tracker not in TRACKERS:
            raise ValueError(f"tracker must be one of {TRACKERS}, got {self.tracker!r}")
        if self.batch_size <= 0 or not 0 < self.max_ready <= self.table_size:
            raise ValueError("batch_size and max_ready must be positive "
                             "(max_ready <= table_size)")
        # the flow engine reads the tracker memories as they are, so their
        # depths must be the model's input geometry; a feature-only flow head
        # runs no model and leaves them free
        if not self.flow_head.needs_logits:
            return
        if self.flow_model == "cnn" and self.top_n != paper_models.CNN_SEQ:
            raise ValueError(f"cnn flow model needs top_n == {paper_models.CNN_SEQ} "
                             f"(got {self.top_n})")
        if self.flow_model == "transformer" and (
                self.top_k != paper_models.TF_PKTS or self.pay_bytes != paper_models.TF_BYTES):
            raise ValueError(
                f"transformer flow model needs top_k == {paper_models.TF_PKTS} and "
                f"pay_bytes == {paper_models.TF_BYTES} (got {self.top_k}/{self.pay_bytes})")


class PipelineStepOutput(NamedTuple):
    """Outputs of one step (static shapes)."""

    pkt_actions: torch.Tensor  # (batch_size,) int32 0 allow / 1 deny
    drained: ft.DrainResult  # max_ready rows + mask
    flow_actions: torch.Tensor  # (max_ready,) int32
    flow_cls: torch.Tensor  # (max_ready,) int32
    flow_scores: torch.Tensor  # (max_ready,) float32 — the flow head's score
    new_flows: torch.Tensor  # () int32 — flows established this step
    evicted: torch.Tensor  # () int32 — stale flows recycled by collision
    fallback_slots: torch.Tensor  # () int32 — slots that took the scan fallback


class LatencyReservoir:
    """Bounded ring-buffer sample for percentile latency reporting: only the
    most recent ``capacity`` samples are kept.  Idle reservoirs report
    ``nan``."""

    __slots__ = ("capacity", "_buf", "_n")

    def __init__(self, capacity: int = 1024):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self._buf = np.empty(capacity, np.float64)
        self._n = 0  # total added; the ring holds the last min(n, capacity)

    def add(self, value: float) -> None:
        self._buf[self._n % self.capacity] = value
        self._n += 1

    def __len__(self) -> int:
        return min(self._n, self.capacity)

    def percentile(self, q: float) -> float:
        if self._n == 0:
            return float("nan")
        return float(np.percentile(self._buf[: len(self)], q))

    @property
    def p50(self) -> float:
        return self.percentile(50.0)

    @property
    def p99(self) -> float:
        return self.percentile(99.0)


@dataclass
class PipelineStats:
    """Sustained-loop counters.  ``host_s`` is the time the host spent in
    Python and dispatch (including any wait inside the step, such as the
    collision check); ``device_s`` is the wait at the step's closing
    synchronize, the device work the host could not hide."""

    steps: int = 0
    total_s: float = 0.0
    packets: int = 0
    flows: int = 0  # ready flows emitted + classified
    new_flows: int = 0
    evicted: int = 0
    fallback_steps: int = 0  # steps whose batch took the scan fallback
    host_s: float = 0.0
    device_s: float = 0.0
    lat: LatencyReservoir = field(default_factory=LatencyReservoir)

    def record_step(self, dt: float, *, packets: int, flows: int, new_flows: int,
                    evicted: int, fallback: bool, host_s: float, device_s: float) -> None:
        self.steps += 1
        self.total_s += dt
        self.packets += packets
        self.flows += flows
        self.new_flows += new_flows
        self.evicted += evicted
        self.fallback_steps += int(fallback)
        self.host_s += host_s
        self.device_s += device_s
        self.lat.add(dt * 1e6)

    @property
    def pkt_per_s(self) -> float:
        return self.packets / self.total_s if self.total_s > 0 else 0.0

    @property
    def flow_per_s(self) -> float:
        return self.flows / self.total_s if self.total_s > 0 else 0.0

    @property
    def step_us(self) -> float:
        return self.total_s / self.steps * 1e6 if self.steps else float("nan")

    @property
    def host_us(self) -> float:
        return self.host_s / self.steps * 1e6 if self.steps else float("nan")

    @property
    def device_us(self) -> float:
        return self.device_s / self.steps * 1e6 if self.steps else float("nan")

    @property
    def p50_us(self) -> float:
        return self.lat.p50

    @property
    def p99_us(self) -> float:
        return self.lat.p99


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class OctopusPipeline:
    """Streaming serving loop composing the tracker and both inference
    engines under one :class:`RuntimeConfig`.

    Runs on the card unless ``device`` names another; with no card and no
    device it raises.  Parameters (dicts of tensors with the reference's
    names) move to the pipeline's device."""

    def __init__(self, packet_params: dict, flow_params: dict,
                 cfg: PipelineConfig = PipelineConfig(), *,
                 config: Optional[RuntimeConfig] = None,
                 program: Optional[torch.Tensor] = None, device: Device = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.runtime = config if config is not None else RuntimeConfig()
        to_dev = lambda params: {k: v.to(self.device) for k, v in params.items()}
        self.packet_engine = PacketEngine(to_dev(packet_params), config=self.runtime)
        self.flow_engine = FlowEngine(to_dev(flow_params), cfg.flow_model,
                                      config=self.runtime)
        program = default_program(self.device) if program is None else program
        check_program(program)
        self.program = program.to(self.device)
        self.rules = decisions.RuleTable()  # the switch-facing table (step 6)
        self.stats = PipelineStats()
        self.state = self._fresh_state()

    def _fresh_state(self) -> ft.TrackerState:
        c = self.cfg
        return ft.init_state(c.table_size, c.top_n, c.top_k, c.pay_bytes, device=self.device)

    # ------------------------------------------------------------ steps 2-5
    def _track(self, state: ft.TrackerState, packets: ft.PacketBatch
               ) -> tuple[ft.TrackerState, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Step 2: merge one microbatch under ``cfg.tracker``; returns
        ``(state, new_flows, evicted, fallback_slots)``."""
        if self.cfg.tracker == "segmented":
            state, seg = fx.segmented_update(state, packets, self.program,
                                             top_n=self.cfg.top_n)
            return state, seg.new_flows, seg.evicted, seg.fallback_slots
        state, outs = ft.process_packets(state, packets, self.program, top_n=self.cfg.top_n)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        return (state, outs.new_flow.sum().to(torch.int32),
                outs.evicted.sum().to(torch.int32), zero)

    def _decide_pkt(self, packets: ft.PacketBatch) -> torch.Tensor:
        """Steps 4+5, packet side."""
        head = self.cfg.pkt_head
        logits = None
        if head.needs_logits:
            with name_scope("pkt"):
                logits = self.packet_engine.fn(self.packet_engine.params,
                                               fx.packet_meta_features(packets))
        return head.decide(logits, packets)

    def _decide_flow(self, drained: ft.DrainResult
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Steps 4+5, flow side."""
        head = self.cfg.flow_head
        logits = None
        if head.needs_logits:
            flow_x = self.flow_engine.prep(drained.series, drained.payload)
            with name_scope("flow"):
                logits = self.flow_engine.fn(self.flow_engine.params, flow_x)
        return head.decide(logits, drained)

    def _step_core(self, state: ft.TrackerState, packets: ft.PacketBatch
                   ) -> tuple[ft.TrackerState, PipelineStepOutput]:
        state, new_flows, evicted, fallback = self._track(state, packets)
        state, drained = ft.drain_ready(state, top_n=self.cfg.top_n,
                                        max_ready=self.cfg.max_ready)
        pkt_actions = self._decide_pkt(packets)
        flow_actions, flow_cls, flow_scores = self._decide_flow(drained)
        return state, PipelineStepOutput(
            pkt_actions=pkt_actions, drained=drained, flow_actions=flow_actions,
            flow_cls=flow_cls, flow_scores=flow_scores, new_flows=new_flows,
            evicted=evicted, fallback_slots=fallback)

    # ------------------------------------------------------------ host loop
    def _zero_batch(self) -> ft.PacketBatch:
        p, c = self.cfg.batch_size, self.cfg
        z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=self.device)
        return ft.PacketBatch(ts=z(p), size=z(p), dir=z(p), flags=z(p), proto=z(p),
                              tuple_hash=z(p), payload=z(p, c.pay_bytes))

    def warmup(self) -> None:
        """Run one step on a throwaway state and an all-zero batch (the live
        table, rules and stats are untouched), so the kernels are built and
        the device initialised before anything is timed."""
        self._step_core(self._fresh_state(), self._zero_batch())
        _synchronize(self.device)

    def _feedback(self, tuple_hash: np.ndarray, out: PipelineStepOutput) -> int:
        """Step 6: decisions -> the rule table.  Returns the emitted flows."""
        self.rules.update(tuple_hash, out.pkt_actions.cpu().numpy())
        mask = out.drained.mask.cpu().numpy()
        n_flows = int(mask.sum())
        if n_flows:
            self.rules.update(out.drained.tuple_id.cpu().numpy()[mask],
                              out.flow_actions.cpu().numpy()[mask],
                              out.flow_cls.cpu().numpy()[mask])
        return n_flows

    def step(self, packets: ft.PacketBatch, *, pull_s: float = 0.0) -> PipelineStepOutput:
        """Run one microbatch of ``batch_size`` packets through steps 2-6.
        ``pull_s`` charges host time spent producing the batch to this step."""
        n = int(packets.ts.shape[0])
        if n != self.cfg.batch_size:
            raise ValueError(f"microbatch must have batch_size={self.cfg.batch_size} "
                             f"packets, got {n}")
        t0 = time.perf_counter()
        packets = ft.PacketBatch(*(a.to(self.device) for a in packets))
        self.state, out = self._step_core(self.state, packets)
        t1 = time.perf_counter()
        _synchronize(self.device)
        t2 = time.perf_counter()
        n_flows = self._feedback(packets.tuple_hash.cpu().numpy(), out)
        t3 = time.perf_counter()
        host_s = pull_s + (t1 - t0) + (t3 - t2)
        self.stats.record_step(
            host_s + (t2 - t1), packets=n, flows=n_flows, new_flows=int(out.new_flows),
            evicted=int(out.evicted), fallback=int(out.fallback_slots) > 0,
            host_s=host_s, device_s=t2 - t1)
        return out

    def run(self, traffic: Iterable[ft.PacketBatch],
            steps: Optional[int] = None) -> PipelineStats:
        """Drive the loop from an iterable of microbatches (e.g. a
        :class:`repro_torch.data.traffic.TrafficGenerator`, which streams
        forever — pass ``steps`` to bound it) and return the sustained stats.
        Pulling each batch is charged to ``host_us``."""
        it = iter(traffic)
        for _ in (itertools.count() if steps is None else range(steps)):
            t0 = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                break
            self.step(batch, pull_s=time.perf_counter() - t0)
        return self.stats

    def reset(self) -> None:
        """Fresh table, rule set and counters."""
        self.state = self._fresh_state()
        self.rules = decisions.RuleTable()
        self.stats = PipelineStats()

    # ------------------------------------------------------------- placement
    def plan(self) -> RoutePlan:
        """One RoutePlan over the matmuls the decision heads consume, in step
        order (the packet engine under the ``pkt/`` name scope, then the flow
        engine under ``flow/``), traced on ``meta`` tensors: nothing runs.
        Feature-only heads contribute no matmuls."""
        use_pkt = self.cfg.pkt_head.needs_logits
        use_flow = self.cfg.flow_head.needs_logits

        def engines(pkt_params, px, flow_params, fx_):
            if use_pkt:
                with name_scope("pkt"):
                    self.packet_engine.fn(pkt_params, px)
            if use_flow:
                with name_scope("flow"):
                    self.flow_engine.fn(flow_params, fx_)

        return RoutePlan.trace(
            engines, self.packet_engine.params,
            self.packet_engine.abstract_input(self.cfg.batch_size),
            self.flow_engine.params, self.flow_engine.abstract_input(self.cfg.max_ready),
            config=self.runtime)

    def explain(self) -> str:
        """Placement report for the step: the combined plan plus the
        per-engine split (a feature-only head's engine reads as skipped)."""
        plan = self.plan()
        pkt = plan.scoped("pkt", strip=True)
        flow = plan.scoped("flow", strip=True)
        c = self.cfg
        head = (f"OctopusPipeline: batch={c.batch_size} max_ready={c.max_ready} "
                f"flow_model={c.flow_model} table={c.table_size} top_n={c.top_n} "
                f"tracker={c.tracker} scan_len={c.scan_len}"
                f" heads={c.pkt_head.name}/{c.flow_head.name}")
        fmt = lambda p: ", ".join(f"{s.name}->{s.engine}" for s in p.steps)
        eng = lambda p, on: (f"({len(p)} matmuls): {fmt(p)}" if on
                             else "skipped (feature-only head)")
        return "\n".join([
            head, plan.explain(),
            f"  packet-engine {eng(pkt, c.pkt_head.needs_logits)}",
            f"  flow-engine {eng(flow, c.flow_head.needs_logits)}",
        ])
