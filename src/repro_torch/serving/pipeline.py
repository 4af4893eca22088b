"""The streaming in-network serving pipeline (paper §2.3 working procedure).

One continuous loop over packet microbatches — the paper's steps 1 -> 6:

  1. parse    — ingest a :class:`PacketBatch` microbatch
  2. track    — merge it into the hash-indexed flow table: the segmented
                update (:func:`feature_extractor.segmented_update`, the
                ``flow_update`` kernel on the card) or the scan oracle
                (:func:`flow_tracker.process_packets`); both are bit-identical.
                With ``cold_size > 0`` the table has a second level
                (:mod:`repro_torch.core.cold_store`): evicted flows spill into
                a large cold table and promote back when they return
  3. extract  — drain up to ``max_ready`` ready flows (count >= top_n) and
                recycle their slots (:func:`flow_tracker.drain_ready`)
  4. infer    — per-packet features -> :class:`PacketEngine` (MLP); drained
                flow series or payloads -> :class:`FlowEngine` (CNN or
                transformer), both through the routed engine kernels
  5. decide   — logits -> allow/deny + class ids
  6. feed back — decisions update the switch-facing rule table (host side)

Steps 2-5 are enqueued on the pipeline's device, one microbatch per
:meth:`OctopusPipeline.step` (``scan_len`` of them per :meth:`step_many`);
the output shapes are static (``batch_size`` packets in, ``max_ready``
masked flow rows out).  The host reads a step's outputs back once, packed
into one int32 tensor copied to pinned memory behind a CUDA event.  With
``overlap=True`` ``step``/``step_many`` return an :class:`InflightDispatch`
as soon as the work is enqueued; its ``wait`` blocks on that one copy, not
on the device, applies the rule-table feedback and records the stats.
Handles waited in dispatch order give the eager loop's results bit for bit,
since the rule table never feeds the device work, and ``run``
double-buffers over them.  The host still waits inside a step where the
tracker needs a count: the segmented merge's collision check, and each
round of the cold store's ordered walks.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.common.util import Device, resolve_device
from repro_torch.core import cold_store
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
    """Static shapes + thresholds of the streaming loop."""

    batch_size: int = 32  # packets per microbatch (step granularity)
    max_ready: int = 8  # ready-flow rows drained per step
    flow_model: str = "cnn"
    table_size: int = 1024  # flow-state table depth (paper: 8192)
    top_n: int = paper_models.CNN_SEQ  # ready threshold / series depth
    top_k: int = paper_models.TF_PKTS  # payload rows per flow
    pay_bytes: int = paper_models.TF_BYTES  # payload bytes per packet
    tracker: str = "segmented"  # "segmented" (vectorized) | "scan" (oracle)
    scan_len: int = 1  # microbatches per dispatch (step_many)
    overlap: bool = False  # deferred-sync dispatch: step/step_many return an
    # InflightDispatch handle; run() double-buffers over it
    cold_size: int = 0  # second-level (cold) flow table slots; 0 disables
    cold_policy: str = "age"  # cold eviction policy: "age" | "lru"
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
        if self.flow_model not in FLOW_MODELS:
            raise ValueError(f"flow_model must be one of {FLOW_MODELS}, "
                             f"got {self.flow_model!r}")
        if self.tracker not in TRACKERS:
            raise ValueError(f"tracker must be one of {TRACKERS}, got {self.tracker!r}")
        if self.batch_size <= 0 or not 0 < self.max_ready <= self.table_size:
            raise ValueError("batch_size and max_ready must be positive "
                             "(max_ready <= table_size)")
        if self.scan_len <= 0:
            raise ValueError(f"scan_len must be positive, got {self.scan_len}")
        if self.cold_size < 0:
            raise ValueError(f"cold_size must be >= 0, got {self.cold_size}")
        if self.cold_policy not in cold_store.COLD_POLICIES:
            raise ValueError(f"cold_policy must be one of {cold_store.COLD_POLICIES}, "
                             f"got {self.cold_policy!r}")
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
    """Outputs of one step (static shapes); :meth:`OctopusPipeline.step_many`
    returns the same tuple with a leading ``scan_len`` axis on every leaf."""

    pkt_actions: torch.Tensor  # (batch_size,) int32 0 allow / 1 deny
    drained: ft.DrainResult  # max_ready rows + mask
    flow_actions: torch.Tensor  # (max_ready,) int32
    flow_cls: torch.Tensor  # (max_ready,) int32
    flow_scores: torch.Tensor  # (max_ready,) float32 — the flow head's score
    new_flows: torch.Tensor  # () int32 — flows established this step
    evicted: torch.Tensor  # () int32 — stale flows recycled by collision
    fallback_slots: torch.Tensor  # () int32 — slots that took the scan fallback
    spilled: torch.Tensor  # () int32 — evictions spilled into the cold store
    promoted: torch.Tensor  # () int32 — cold entries promoted back into hot


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

    @property
    def total_added(self) -> int:
        return self._n

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
    """Sustained-loop counters, all folded in by :meth:`record_dispatch`,
    once per dispatch: ``steps`` counts pipeline steps (a chunk advances
    ``scan_len``), ``dispatches`` host round trips, ``packets`` real packets
    (a masked bucket's padding rows count as ``padded``).  ``host_s`` is the
    host's share (enqueue, including any wait inside the step such as the
    collision check, feedback and pulls); ``device_s`` the exposed wait for
    the step's read-back, the device work the host could not hide."""

    steps: int = 0
    total_s: float = 0.0
    packets: int = 0
    flows: int = 0  # ready flows emitted + classified
    new_flows: int = 0
    evicted: int = 0
    spilled: int = 0  # evictions captured by the cold store (cold_size > 0)
    promoted: int = 0  # cold entries re-established into hot
    fallback_steps: int = 0  # steps whose batch took the scan fallback
    dispatches: int = 0  # host round trips (a chunk is one)
    padded: int = 0  # dispatched-but-masked bucket rows
    host_s: float = 0.0
    device_s: float = 0.0
    lat: LatencyReservoir = field(default_factory=LatencyReservoir)

    def record_dispatch(self, dt: float, *, packets: int, steps: int = 1,
                        dispatches: int = 1, flows: int = 0, new_flows: int = 0,
                        evicted: int = 0, spilled: int = 0, promoted: int = 0,
                        fallback_steps: int = 0, padded: int = 0, host_s: float = 0.0,
                        device_s: float = 0.0) -> None:
        """Fold one timed dispatch (one step, or a chunk of ``steps``) into
        the counters; ``host_s``/``device_s`` split ``dt``."""
        self.total_s += dt
        self.packets += packets
        self.steps += steps
        self.dispatches += dispatches
        self.flows += flows
        self.new_flows += new_flows
        self.evicted += evicted
        self.spilled += spilled
        self.promoted += promoted
        self.fallback_steps += fallback_steps
        self.padded += padded
        self.host_s += host_s
        self.device_s += device_s
        self.lat.add(dt * 1e6)  # one sample per timed dispatch (us)

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
    def dispatch_us(self) -> float:
        """Wall time per host round trip (``step_us`` divides by steps)."""
        return self.total_s / self.dispatches * 1e6 if self.dispatches else float("nan")

    @property
    def host_us(self) -> float:
        """Mean host time per dispatch."""
        return self.host_s / self.dispatches * 1e6 if self.dispatches else float("nan")

    @property
    def device_us(self) -> float:
        """Mean exposed device wait per dispatch."""
        return self.device_s / self.dispatches * 1e6 if self.dispatches else float("nan")

    @property
    def p50_us(self) -> float:
        return self.lat.p50

    @property
    def p99_us(self) -> float:
        return self.lat.p99


class InflightDispatch:
    """Handle for one deferred-sync dispatch (``PipelineConfig.overlap``).

    The device work and the copy of its outputs to the host are enqueued
    when the handle exists; nothing has been waited on.  :meth:`wait` blocks
    on that copy's event (not on the device, so later enqueued steps keep
    running), applies the rule-table feedback (step 6) and folds the
    dispatch into the stats — what the eager path does inline.  Handles
    waited in dispatch order give the eager loop's results.

    ``wait`` is idempotent: the first call resolves and caches the output;
    the dispatch is recorded once.  :meth:`add_host_time` charges host work
    done on this dispatch's behalf (``run`` charges the batch pull here)."""

    __slots__ = ("steps", "packets", "_finish", "_host_extra_s", "_out")

    def __init__(self, finish: Callable[[float], PipelineStepOutput], *, steps: int,
                 packets: int):
        self._finish = finish
        self.steps = steps  # pipeline steps this dispatch advances
        self.packets = packets  # real packets it carries
        self._host_extra_s = 0.0
        self._out: Optional[PipelineStepOutput] = None

    @property
    def done(self) -> bool:
        return self._out is not None

    def add_host_time(self, dt_s: float) -> None:
        """No effect after :meth:`wait`."""
        self._host_extra_s += dt_s

    def wait(self) -> PipelineStepOutput:
        if self._out is None:
            self._out = self._finish(self._host_extra_s)
            self._finish = None  # drop the closure (it holds device tensors)
        return self._out


class _Readback:
    """A step's host-side outputs: the int32 ``packed`` tensor, copied without
    blocking into pinned host memory behind a CUDA event on the card (on the
    CPU it is already there).  :meth:`wait` blocks on that event alone."""

    def __init__(self, packed: torch.Tensor):
        self._event = None
        if packed.device.type == "cuda":
            self._host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
            self._host.copy_(packed, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = packed

    def wait(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class _Fields(NamedTuple):
    """The packed read-back of one step, split (:func:`_pack`)."""
    pkt_actions: np.ndarray
    mask: np.ndarray
    tuple_id: np.ndarray
    flow_actions: np.ndarray
    flow_cls: np.ndarray
    new_flows: int
    evicted: int
    fallback_slots: int
    spilled: int
    promoted: int
    tuple_hash: Optional[np.ndarray]


_COUNTERS = ("new_flows", "evicted", "fallback_slots", "spilled", "promoted")


def _pack(out: PipelineStepOutput, tuple_hash: Optional[torch.Tensor]) -> torch.Tensor:
    """One step's outputs the host reads, as one int32 vector: packet
    actions (P), drained mask, tuple ids, flow actions and classes (R each),
    the five counters, then the batch's hashes where the host lacks them."""
    parts = [out.pkt_actions, out.drained.mask, out.drained.tuple_id, out.flow_actions,
             out.flow_cls, torch.stack([getattr(out, name) for name in _COUNTERS])]
    if tuple_hash is not None:
        parts.append(tuple_hash)
    return torch.cat([p.reshape(-1).to(torch.int32) for p in parts])


def _unpack(row: np.ndarray, p: int, r: int) -> _Fields:
    at = p + 4 * r
    end = at + len(_COUNTERS)
    return _Fields(row[:p], row[p:p + r].astype(bool), row[p + r:p + 2 * r],
                   row[p + 2 * r:p + 3 * r], row[p + 3 * r:at], *map(int, row[at:end]),
                   tuple_hash=row[end:] if row.shape[0] > end else None)


def _stack(outs: Sequence[PipelineStepOutput]) -> PipelineStepOutput:
    """Step outputs stacked on a leading axis, leaf by leaf."""
    stack = lambda *leaves: torch.stack(leaves)
    return PipelineStepOutput(*(
        ft.DrainResult(*map(stack, *leaves)) if isinstance(leaves[0], ft.DrainResult)
        else stack(*leaves) for leaves in zip(*outs)))


class OctopusPipeline:
    """Streaming serving loop composing the tracker and both inference
    engines under one :class:`RuntimeConfig`.

    Runs on the card unless ``device`` names another; with no card and no
    device it raises.  Parameters (dicts of tensors with the reference's
    names) move to the pipeline's device.  The pipeline owns its state: the
    cold store (``cold_size > 0``) updates its leaves in place, so a held
    reference to ``state`` sees them change."""

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
        self._warm_buckets: set[int] = set()  # bucket sizes warmed so far

    def _fresh_state(self):
        """A hot-only :class:`~repro_torch.core.flow_tracker.TrackerState`
        when ``cold_size == 0``, else a
        :class:`~repro_torch.core.cold_store.TwoLevelState`."""
        c = self.cfg
        hot = ft.init_state(c.table_size, c.top_n, c.top_k, c.pay_bytes, device=self.device)
        if not c.cold_size:
            return hot
        return cold_store.TwoLevelState(hot, cold_store.init_cold(
            c.cold_size, c.top_n, c.top_k, c.pay_bytes, device=self.device))

    # ------------------------------------------------------------ steps 2-5
    def _merge(self, hot: ft.TrackerState, packets: ft.PacketBatch,
               keep: Optional[torch.Tensor], *, with_spills: bool = False):
        """The tracker merge under ``cfg.tracker``: ``(hot, new_flows,
        evicted, fallback_slots)``, then the spill records when asked."""
        if self.cfg.tracker == "segmented":
            hot, seg, *spills = fx.segmented_update(
                hot, packets, self.program, top_n=self.cfg.top_n, keep=keep,
                with_spills=with_spills)
            return (hot, seg.new_flows, seg.evicted, seg.fallback_slots, *spills)
        hot, outs, *spills = ft.process_packets(hot, packets, self.program,
                                                top_n=self.cfg.top_n, keep=keep,
                                                with_spills=with_spills)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        return (hot, outs.new_flow.sum().to(torch.int32),
                outs.evicted.sum().to(torch.int32), zero, *spills)

    def _track(self, state, packets: ft.PacketBatch, keep: Optional[torch.Tensor] = None):
        """Step 2: merge one (optionally keep-masked) microbatch.  Returns
        ``(state, new_flows, evicted, fallback_slots, spilled, promoted)``.
        With a cold table the two-level step runs around the same merge:
        promote -> merge with spill records -> spill -> scrub
        (:mod:`repro_torch.core.cold_store`), the cold leaves written in
        place."""
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        if not self.cfg.cold_size:
            return (*self._merge(state, packets, keep), zero, zero)
        policy = self.cfg.cold_policy
        hot, cold, promoted = cold_store.promote_pass(state.hot, state.cold, packets, keep,
                                                      policy=policy)
        hot, new, ev, fb, spills = self._merge(hot, packets, keep, with_spills=True)
        cold, spilled = cold_store.apply_spills(cold, spills, policy=policy)
        cold = cold_store.scrub_live(cold, hot, packets, keep)
        return cold_store.TwoLevelState(hot, cold), new, ev, fb, spilled, promoted

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

    def _lane_core(self, state, packets: ft.PacketBatch, keep: Optional[torch.Tensor] = None
                   ) -> tuple[Any, PipelineStepOutput]:
        """Steps 2-5 for one lane: merge the (optionally keep-masked)
        packets, drain up to ``max_ready`` ready flows from the hot table
        (cold flows come back through promotion first), run both engines,
        decide.  Enqueues device work; reads nothing back beyond the
        tracker's own counts."""
        state, new_flows, evicted, fallback, spilled, promoted = self._track(
            state, packets, keep)
        two_level = bool(self.cfg.cold_size)
        hot, drained = ft.drain_ready(state.hot if two_level else state,
                                      top_n=self.cfg.top_n, max_ready=self.cfg.max_ready)
        state = state._replace(hot=hot) if two_level else hot
        pkt_actions = self._decide_pkt(packets)
        flow_actions, flow_cls, flow_scores = self._decide_flow(drained)
        return state, PipelineStepOutput(
            pkt_actions=pkt_actions, drained=drained, flow_actions=flow_actions,
            flow_cls=flow_cls, flow_scores=flow_scores, new_flows=new_flows,
            evicted=evicted, fallback_slots=fallback, spilled=spilled, promoted=promoted)

    # ------------------------------------------------------------ host loop
    def _zero_batch(self, n: Optional[int] = None) -> ft.PacketBatch:
        p, c = self.cfg.batch_size if n is None else n, self.cfg
        z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=self.device)
        return ft.PacketBatch(ts=z(p), size=z(p), dir=z(p), flags=z(p), proto=z(p),
                              tuple_hash=z(p), payload=z(p, c.pay_bytes))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self) -> None:
        """Run the dispatch ``run`` uses (a chunk of ``scan_len`` steps, or
        one step) on throwaway state and all-zero batches, so the kernels are
        built and the allocator warm before anything is timed; the live
        table, rules and stats are untouched."""
        scratch = self._fresh_state()
        for _ in range(self.cfg.scan_len):
            scratch, _ = self._lane_core(scratch, self._zero_batch())
        self._sync()

    def _check_batch(self, packets: ft.PacketBatch) -> int:
        n = int(packets.ts.shape[0])
        if n != self.cfg.batch_size:
            raise ValueError(f"microbatch must have batch_size={self.cfg.batch_size} "
                             f"packets, got {n}")
        return n

    def _to_device(self, packets: ft.PacketBatch) -> tuple[ft.PacketBatch, Optional[np.ndarray]]:
        """The batch on the pipeline's device, and its hashes on the host
        when the batch came from there (else the read-back carries them)."""
        host = packets.tuple_hash.numpy() if packets.tuple_hash.device.type == "cpu" else None
        return ft.PacketBatch(*(a.to(self.device, non_blocking=True) for a in packets)), host

    def _feedback(self, tuple_hash: np.ndarray, f: _Fields,
                  keep: Optional[np.ndarray] = None) -> int:
        """Step 6 for one step: decisions -> the rule table (padding rows
        left out).  Returns the emitted flows."""
        pkt_actions = f.pkt_actions
        if keep is not None:
            tuple_hash, pkt_actions = tuple_hash[keep], pkt_actions[keep]
        self.rules.update(tuple_hash, pkt_actions)
        n_flows = int(f.mask.sum())
        if n_flows:
            self.rules.update(f.tuple_id[f.mask], f.flow_actions[f.mask], f.flow_cls[f.mask])
        return n_flows

    def _dispatch(self, batches: Sequence[ft.PacketBatch], keep: Optional[np.ndarray] = None,
                  *, stacked: bool) -> InflightDispatch:
        """Enqueue the batches' steps (and, with ``keep``, one masked
        bucket) and their one read-back, without blocking.  The handle's
        ``wait`` blocks on the read-back, applies the feedback in step order
        and records the dispatch."""
        t0 = time.perf_counter()
        keep_dev = None if keep is None else torch.from_numpy(keep).to(self.device)
        outs, packed, hashes = [], [], []
        for batch in batches:
            batch, host_hash = self._to_device(batch)
            self.state, out = self._lane_core(self.state, batch, keep_dev)
            outs.append(out)
            packed.append(_pack(out, batch.tuple_hash if host_hash is None else None))
            hashes.append(host_hash)
        readback = _Readback(torch.stack(packed))
        out = _stack(outs) if stacked else outs[0]
        enqueue_s = time.perf_counter() - t0
        p, r = int(batches[0].ts.shape[0]), self.cfg.max_ready
        n = len(batches) * p if keep is None else int(keep.sum())

        def finish(host_extra_s: float) -> PipelineStepOutput:
            t1 = time.perf_counter()
            rows = readback.wait()
            device_s = time.perf_counter() - t1
            t2 = time.perf_counter()
            fields = [_unpack(row, p, r) for row in rows]
            n_flows = sum(self._feedback(h if h is not None else f.tuple_hash, f, keep)
                          for h, f in zip(hashes, fields))
            host_s = enqueue_s + host_extra_s + (time.perf_counter() - t2)
            self.stats.record_dispatch(
                host_s + device_s, packets=n, steps=len(batches), flows=n_flows,
                new_flows=sum(f.new_flows for f in fields),
                evicted=sum(f.evicted for f in fields),
                spilled=sum(f.spilled for f in fields),
                promoted=sum(f.promoted for f in fields),
                fallback_steps=sum(f.fallback_slots > 0 for f in fields),
                padded=0 if keep is None else p - n, host_s=host_s, device_s=device_s)
            return out

        return InflightDispatch(finish, steps=len(batches), packets=n)

    def _dispatch_step(self, packets: ft.PacketBatch) -> InflightDispatch:
        self._check_batch(packets)
        return self._dispatch([packets], stacked=False)

    def step(self, packets: ft.PacketBatch):
        """Run one microbatch of ``batch_size`` packets through steps 2-6.
        Returns the :class:`PipelineStepOutput`, or with ``cfg.overlap`` an
        :class:`InflightDispatch` to wait in dispatch order."""
        h = self._dispatch_step(packets)
        return h if self.cfg.overlap else h.wait()

    def _dispatch_chunk(self, batches: Sequence[ft.PacketBatch]) -> InflightDispatch:
        L = self.cfg.scan_len
        batches = list(batches)
        if len(batches) != L:
            raise ValueError(f"step_many needs exactly scan_len={L} microbatches, "
                             f"got {len(batches)}")
        for b in batches:
            self._check_batch(b)
        return self._dispatch(batches, stacked=True)

    def step_many(self, batches: Sequence[ft.PacketBatch]):
        """Run exactly ``scan_len`` microbatches as one dispatch: the steps
        enqueue back to back with one read-back for the chunk, and the
        feedback lands after it, in step order.  Returns the outputs stacked
        on a leading ``scan_len`` axis, or with ``cfg.overlap`` an
        :class:`InflightDispatch`."""
        h = self._dispatch_chunk(batches)
        return h if self.cfg.overlap else h.wait()

    # ---------------------------------------------------- bucketed (masked)
    def warm_bucket(self, bucket: int) -> None:
        """Run the masked entry point once at one bucket size on throwaway
        state (idempotent per size), building its kernels and warming the
        allocator for that shape."""
        if bucket <= 0:
            raise ValueError(f"bucket must be positive, got {bucket}")
        if bucket in self._warm_buckets:
            return
        keep = torch.zeros(bucket, dtype=torch.bool, device=self.device)
        self._lane_core(self._fresh_state(), self._zero_batch(bucket), keep)
        self._sync()
        self._warm_buckets.add(bucket)

    def step_masked(self, packets: ft.PacketBatch, keep) -> PipelineStepOutput:
        """One padded request batch of any bucket size (not tied to
        ``cfg.batch_size``): rows with ``keep == False`` are padding, left
        out of the tracker merge, the feedback and the packet count (they
        count as ``padded``).  ``keep`` is a (bucket,) bool array or tensor."""
        bucket = int(packets.ts.shape[0])
        k = keep.cpu().numpy() if isinstance(keep, torch.Tensor) else np.asarray(keep)
        k = k.astype(bool)
        if k.shape != (bucket,):
            raise ValueError(f"keep must have shape ({bucket},), got {k.shape}")
        out = self._dispatch([packets], k, stacked=False).wait()
        self._warm_buckets.add(bucket)
        return out

    def run(self, traffic: Iterable[ft.PacketBatch],
            steps: Optional[int] = None) -> PipelineStats:
        """Drive the loop from an iterable of microbatches (e.g. a
        :class:`repro_torch.data.traffic.TrafficGenerator`, which streams
        forever — pass ``steps`` to bound it) and return the sustained stats.
        With ``scan_len > 1`` batches dispatch in chunks; a final partial
        chunk runs step by step.  With ``cfg.overlap`` chunk k+1 is pulled
        and enqueued before chunk k is waited (feedback lags one dispatch,
        in step order).  Pulls are charged to ``host_us`` in both modes;
        wrap the source in :func:`repro_torch.data.traffic.prefetch` to
        generate batches on a background thread."""
        it = iter(traffic)
        L = self.cfg.scan_len
        done = 0
        pending: Optional[InflightDispatch] = None

        def advance(handle: InflightDispatch, pull_s: float) -> None:
            nonlocal pending
            handle.add_host_time(pull_s)
            if not self.cfg.overlap:
                handle.wait()
                return
            if pending is not None:
                pending.wait()  # dispatch k-1: lagged feedback, in step order
            pending = handle

        while steps is None or done < steps:
            want = L if steps is None else min(L, steps - done)
            t0 = time.perf_counter()
            chunk = list(itertools.islice(it, want))  # never pull past `steps`
            pull_s = time.perf_counter() - t0
            if not chunk:
                break
            if L > 1 and len(chunk) == L:
                advance(self._dispatch_chunk(chunk), pull_s)
            else:
                for batch in chunk:
                    advance(self._dispatch_step(batch), pull_s)
                    pull_s = 0.0  # charge the pull to the first step only
            done += len(chunk)
        if pending is not None:
            pending.wait()  # the in-flight tail
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
                f"tracker={c.tracker} scan_len={c.scan_len}")
        if c.cold_size:
            head += f" cold={c.cold_size}({c.cold_policy})"
        head += f" heads={c.pkt_head.name}/{c.flow_head.name}"
        fmt = lambda p: ", ".join(f"{s.name}->{s.engine}" for s in p.steps)
        eng = lambda p, on: (f"({len(p)} matmuls): {fmt(p)}" if on
                             else "skipped (feature-only head)")
        return "\n".join([
            head, plan.explain(),
            f"  packet-engine {eng(pkt, c.pkt_head.needs_logits)}",
            f"  flow-engine {eng(flow, c.flow_head.needs_logits)}",
        ])
