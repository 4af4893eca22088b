"""Sharded multi-lane serving pipeline (paper §2.2 / §4: parallel extractor
lanes over a multi-bank memory fabric).

:class:`ShardedOctopusPipeline` hash-partitions every microbatch into
``num_shards`` lanes (``shard = tuple_hash % num_shards``, so a flow's
packets always land in one lane and no flow state crosses lanes), runs each
lane's tracker bank, drains each lane's share of ``max_ready`` and merges the
lanes' outputs into one step output with the single-lane shapes, so the
decisions and the rule-table feedback are unchanged downstream.

Two lane backends, as the reference's (``platform.lanes_backend`` picks one
when none is named):

  * ``"vmap"``: the lanes are one lane-batched bank on one device: S lanes
    of ``table_size`` slots are one table of S·F rows (the state's leaves
    are (S, F, ...), and the flat table a view of them), and a packet's row
    is its lane's base plus its slot in the lane
    (:func:`~repro_torch.core.flow_tracker.lane_slot`).  So one segmented
    merge, one collision check, one ``flow_update`` launch and one drain
    serve every lane: two tuples share a row only when they share a lane,
    each row's packets keep their arrival order, and a scan fallback taken
    for one lane's collision is exact for the others.  The two-level table
    keeps S cold lanes with a clock each.  The engines run per lane, under
    ``lane_scope(i)``, at the lane's shapes, so every matmul takes the route
    and kernel variant of the reference's per-lane plan: the packet engine
    once on the whole batch where a lane's capacity is the batch (the same
    M), else per lane and round at ``lane_batch`` rows; the flow engine per
    lane at ``max_ready / num_shards`` rows.
  * ``"shard_map"``: one device a lane on a ``lanes`` mesh
    (:func:`~repro_torch.launch.mesh.make_lanes_mesh`; ``devices`` names
    them, a device may repeat; by default every device of the pipeline's
    backend, :func:`~repro_torch.runtime.platform.devices`): lane ``i``'s
    bank, tracker and cold table, lives on the mesh's device ``i``, and each
    lane runs its step unbatched, the reference's shard_map body: its own
    merge, ``flow_update`` launch, drain and engines, on its window of the
    batch (``lane_batch`` rows, zero-padded; a keep mask marks the lane's
    packets).  The merge of the lanes' outputs is the vmap backend's, so
    ``step``'s output is the same, bit for bit.  ``state`` is the vmap
    backend's stacked type here too (the reference's shard_map keeps it):
    reading it stacks the lanes' states on the pipeline's device, a copy;
    assigning one places lane ``i``'s slice on device ``i``.

Exactness: the merged output equals the reference's sharded pipeline on the
same stream bit for bit, and, where flows sharing a slot also share a lane
and no lane holds back a ready flow, the single-lane pipeline's union of
drained flows and decisions.

Skew: per-lane capacity ``lane_batch`` defaults to the batch (one round a
step).  A smaller one splits each lane's FIFO into windows (rounds, see
:func:`~repro_torch.data.traffic.partition_batch`): every round merges on
its own, in order, and the drain and flow engine run once, after the last.
A round costs no read-back: the partition is computed on the host, from the
batch's hashes (read back once where the batch lives on the card).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.common.util import Device, resolve_device
from repro_torch.core import cold_store
from repro_torch.core import flow_tracker as ft
from repro_torch.data.traffic import lane_rounds
from repro_torch.launch.mesh import make_lanes_mesh
from repro_torch.runtime import platform
from repro_torch.runtime.config import RuntimeConfig
from repro_torch.runtime.plan import RoutePlan
from repro_torch.runtime.routing import lane_scope, name_scope
from repro_torch.serving.pipeline import OctopusPipeline, PipelineConfig, PipelineStepOutput

LANE_BACKENDS = ("vmap", "shard_map")


class ShardedOctopusPipeline(OctopusPipeline):
    """Hash-partitioned multi-lane :class:`OctopusPipeline`.

    The same public surface as the single lane: ``step`` takes a
    ``batch_size`` microbatch and returns a merged :class:`PipelineStepOutput`
    of the same shapes (``pkt_actions`` in batch order; ``max_ready`` drained
    rows, lane-major, ``lane_ready`` a lane, with lane-local slots).  The
    state is the lanes' stack under either backend: tracker leaves (S, F,
    ...), and with a cold table cold leaves (S, C, ...) and the clocks (S,);
    under ``shard_map`` the lanes keep their own states, each on its device,
    and ``state`` reads and writes them as that stack."""

    def __init__(self, packet_params: dict, flow_params: dict,
                 cfg: PipelineConfig = PipelineConfig(), *, num_shards: int,
                 lane_batch: Optional[int] = None, backend: Optional[str] = None,
                 config: Optional[RuntimeConfig] = None,
                 program: Optional[torch.Tensor] = None, device: Device = None,
                 devices: Optional[Sequence[Device]] = None):
        if num_shards <= 0:
            raise ValueError(f"num_shards must be positive, got {num_shards}")
        if cfg.max_ready % num_shards:
            raise ValueError(f"max_ready={cfg.max_ready} must divide evenly into "
                             f"num_shards={num_shards} lane budgets")
        self.num_shards = num_shards
        self.lane_ready = cfg.max_ready // num_shards
        self.lane_batch = cfg.batch_size if lane_batch is None else int(lane_batch)
        if not 0 < self.lane_batch <= cfg.batch_size:
            raise ValueError(f"lane_batch must be in [1, {cfg.batch_size}], "
                             f"got {self.lane_batch}")
        if cfg.scan_len > 1 and self.lane_batch != cfg.batch_size:
            raise ValueError("scan_len > 1 needs the skew-proof lane_batch == batch_size "
                             "(overflow rounds are dispatched per step, not scanned)")
        if backend is None:
            backend = platform.lanes_backend(
                num_shards, resolve_device(device) if devices is None else devices[0])
        self.backend = backend
        if self.backend not in LANE_BACKENDS:
            raise ValueError(f"backend must be one of {LANE_BACKENDS}, got {self.backend!r}")
        # the lanes must exist before super().__init__ builds the state
        self.mesh, self.lanes = None, ()
        if self.backend == "shard_map":
            self.mesh = make_lanes_mesh(
                num_shards, platform.devices(device) if devices is None else devices)
            lane_cfg = dataclasses.replace(cfg, max_ready=self.lane_ready)
            self.lanes = tuple(OctopusPipeline(packet_params, flow_params, lane_cfg,
                                               config=config, program=program, device=d)
                               for d in self.mesh.devices)
            for lane in self.lanes:
                lane.state = None  # the sharded pipeline holds the lanes' states
            self._lane_states: tuple = ()
            if device is None:
                device = self.mesh.devices[0]
        elif devices is not None:
            raise ValueError("devices name the lanes of backend='shard_map'")
        super().__init__(packet_params, flow_params, cfg, config=config, program=program,
                         device=device)

    # ----------------------------------------------------------- lane bank
    @property
    def state(self):
        """The lanes' stacked state.  Under shard_map the lanes' own states
        stacked on the pipeline's device: a copy, which later steps do not
        change."""
        if self.mesh is None:
            return self._state
        return self._stacked(self._lane_states)

    @state.setter
    def state(self, value) -> None:
        """Under shard_map a stacked state is cut into the lanes' states,
        lane ``i``'s on its device (copies); the lanes' own tuple (a fresh
        state) is kept as it is."""
        if self.mesh is None:
            self._state = value
        elif isinstance(value, (ft.TrackerState, cold_store.TwoLevelState)):
            self._lane_states = tuple(self._lane_of(value, i, lane.device)
                                      for i, lane in enumerate(self.lanes))
        else:
            self._lane_states = tuple(value)

    def _stacked(self, lane_states: tuple):
        dev = self.device

        def stack(parts):
            return type(parts[0])(*(torch.stack([leaf.to(dev) for leaf in leaves])
                                    for leaves in zip(*parts)))

        if self.cfg.cold_size:
            return cold_store.TwoLevelState(stack([st.hot for st in lane_states]),
                                            stack([st.cold for st in lane_states]))
        return stack(lane_states)

    @staticmethod
    def _lane_of(stacked, i: int, device: torch.device):
        def cut(tree):
            return type(tree)(*(leaf[i].to(device, copy=True) for leaf in tree))

        if isinstance(stacked, cold_store.TwoLevelState):
            return cold_store.TwoLevelState(cut(stacked.hot), cut(stacked.cold))
        return cut(stacked)

    def _fresh_state(self):
        """The lanes' stack: one bank of S times the table (and cold) size,
        each lane's cold clock its own; under shard_map each lane's own
        state on its device."""
        if self.mesh is not None:
            return tuple(lane._fresh_state() for lane in self.lanes)
        c, S = self.cfg, self.num_shards
        flat = ft.init_state(S * c.table_size, c.top_n, c.top_k, c.pay_bytes, device=self.device)
        if c.cold_size:
            cold = cold_store.init_cold(S * c.cold_size, c.top_n, c.top_k, c.pay_bytes,
                                        device=self.device)
            flat = cold_store.TwoLevelState(flat, cold._replace(
                tick=torch.zeros(S, dtype=torch.int32, device=self.device)))
        return self._lanes_view(flat, stacked=True)

    def _lanes_view(self, state, *, stacked: bool):
        """The state's leaves as the lanes' stack (S, rows, ...) or as one bank
        (S·rows, ...), without a copy: the cold store writes through the
        bank's views of the cold leaves.  The clocks stay (S,)."""
        S, two_level = self.num_shards, bool(self.cfg.cold_size)
        shape = ((lambda leaf: (S, -1, *leaf.shape[1:])) if stacked
                 else (lambda leaf: (-1, *leaf.shape[2:])))
        hot = ft.TrackerState(*(leaf.reshape(shape(leaf))
                                for leaf in (state.hot if two_level else state)))
        if not two_level:
            return hot
        cold = state.cold
        return cold_store.TwoLevelState(hot, cold_store.ColdState(
            *(leaf.view(shape(leaf)) for leaf in cold[:-1]), tick=cold.tick))

    # ------------------------------------------------------------ steps 2-5
    def _decide_flow(self, drained: ft.DrainResult):
        """Steps 4+5, flow side: each lane's ``lane_ready`` rows through the
        flow engine under its ``lane<i>/`` scope, then one decision."""
        head = self.cfg.flow_head
        logits = None
        if head.needs_logits:
            R, parts = self.lane_ready, []
            for i in range(self.num_shards):
                rows = slice(i * R, (i + 1) * R)
                flow_x = self.flow_engine.prep(drained.series[rows], drained.payload[rows])
                with lane_scope(i), name_scope("flow"):
                    parts.append(self.flow_engine.fn(self.flow_engine.params, flow_x))
            logits = torch.cat(parts)
        return head.decide(logits, drained)

    def _drain_merge(self, flat, pkt_actions: torch.Tensor, counters) -> tuple:
        """Drain every lane, run the flow engine, and assemble the merged
        output from the step's packet verdicts and summed counters."""
        two_level = bool(self.cfg.cold_size)
        hot, drained = ft.drain_ready(flat.hot if two_level else flat, top_n=self.cfg.top_n,
                                      max_ready=self.cfg.max_ready, lanes=self.num_shards)
        flat = flat._replace(hot=hot) if two_level else hot
        flow_actions, flow_cls, flow_scores = self._decide_flow(drained)
        new_flows, evicted, fallback, spilled, promoted = counters
        return self._lanes_view(flat, stacked=True), PipelineStepOutput(
            pkt_actions=pkt_actions, drained=drained, flow_actions=flow_actions,
            flow_cls=flow_cls, flow_scores=flow_scores, new_flows=new_flows,
            evicted=evicted, fallback_slots=fallback, spilled=spilled, promoted=promoted)

    def _lanes_step(self, states: tuple, packets: ft.PacketBatch, host_hash: np.ndarray,
                    keep: Optional[np.ndarray], cap: int) -> tuple:
        """One step on the shard_map lanes: round r hands every lane its r-th
        window of ``cap`` packets (zero rows pad it, a keep mask marks the
        lane's packets) on its device; every lane merges every round (its
        packet engine on a non-empty window), and in the last round runs
        its whole step (merge, drain of ``lane_ready`` rows, both engines).
        The lanes' verdicts scatter back to batch order, their drained rows
        and flow decisions concatenate lane-major and their counters sum,
        on the pipeline's device.  Returns ``(states, out, rounds)``."""
        n, dev = packets.ts.shape[0], self.device
        lane, rnd, rounds = lane_rounds(host_hash, self.num_shards, lane_batch=cap, keep=keep)
        padded = ft.PacketBatch(*(torch.cat([a, a.new_zeros((1, *a.shape[1:]))])
                                  for a in packets))
        states = list(states)
        pkt_actions = torch.zeros(n, dtype=torch.int32, device=dev)
        totals: list = [None] * self.num_shards
        outs: list = [None] * self.num_shards
        for r in range(rounds):
            last = r == rounds - 1
            for i, pipe in enumerate(self.lanes):
                rows = np.flatnonzero((lane == i) & (rnd == r))
                k = rows.shape[0]
                src = np.full(cap, n, np.int64)
                src[:k] = rows
                src_dev = torch.from_numpy(src).to(dev)
                window = ft.PacketBatch(*(a[src_dev].to(pipe.device, non_blocking=True)
                                          for a in padded))
                in_lane = (torch.arange(cap) < k).to(pipe.device)
                acts = None
                with lane_scope(i):
                    if last:
                        states[i], outs[i] = pipe._lane_core(states[i], window, in_lane)
                        acts, counters = outs[i].pkt_actions, (
                            outs[i].new_flows, outs[i].evicted, outs[i].fallback_slots,
                            outs[i].spilled, outs[i].promoted)
                    else:
                        states[i], *counters = pipe._track(states[i], window, in_lane)
                        if k:
                            acts = pipe._decide_pkt(window)
                counters = [c.to(dev) for c in counters]
                totals[i] = counters if totals[i] is None else [
                    a + b for a, b in zip(totals[i], counters)]
                if k:
                    pkt_actions[src_dev[:k]] = acts[:k].to(dev)
        cat = lambda get: torch.cat([get(o).to(dev) for o in outs])
        drained = ft.DrainResult(*(cat(lambda o, f=f: o.drained[f])
                                   for f in range(len(ft.DrainResult._fields))))
        counters = [sum(parts[1:], parts[0]) for parts in zip(*totals)]
        new_flows, evicted, fallback, spilled, promoted = counters
        return tuple(states), PipelineStepOutput(
            pkt_actions=pkt_actions, drained=drained,
            flow_actions=cat(lambda o: o.flow_actions), flow_cls=cat(lambda o: o.flow_cls),
            flow_scores=cat(lambda o: o.flow_scores), new_flows=new_flows, evicted=evicted,
            fallback_slots=fallback, spilled=spilled, promoted=promoted), rounds

    def _lane_core(self, state, packets: ft.PacketBatch, keep: Optional[torch.Tensor] = None):
        """One round a lane: every lane's rows of the (optionally keep-masked)
        batch merge at once, each lane drains its share, the packet engine
        runs once on the batch (a lane's capacity is the batch, so its M is
        the lane's) and the flow engine per lane.  Padding rows get verdict
        0, as rows in no lane.  Under shard_map: :meth:`_lanes_step` at the
        batch's capacity."""
        if self.mesh is not None:
            k = None if keep is None else keep.cpu().numpy()
            state, out, _ = self._lanes_step(state, packets, packets.tuple_hash.cpu().numpy(),
                                             k, int(packets.ts.shape[0]))
            return state, out
        flat, *counters = self._track(self._lanes_view(state, stacked=False), packets, keep,
                                      lanes=self.num_shards)
        pkt_actions = self._decide_pkt(packets)
        if keep is not None:
            pkt_actions = torch.where(keep, pkt_actions, 0)
        return self._drain_merge(flat, pkt_actions, counters)

    def _rounds_core(self, state, packets: ft.PacketBatch, host_hash: np.ndarray):
        """A step whose lanes overflow ``lane_batch``: round r merges every
        lane's r-th window of ``lane_batch`` packets (a keep mask over the
        batch), and the packet engine runs per lane and round at
        ``lane_batch`` rows (zero rows pad a short window; an empty window
        runs nothing, its verdicts being those of no packet); the drain and
        the flow engine run once, after the last round.  Returns ``(state,
        out, rounds)``."""
        n, C, dev = packets.ts.shape[0], self.lane_batch, self.device
        lane, rnd, rounds = lane_rounds(host_hash, self.num_shards, lane_batch=C)
        flat = self._lanes_view(state, stacked=False)
        zero_row = ft.PacketBatch(*(torch.cat([a, a.new_zeros((1, *a.shape[1:]))])
                                    for a in packets))
        pkt_actions = torch.zeros(n, dtype=torch.int32, device=dev)
        totals = None
        for r in range(rounds):
            in_round = rnd == r
            flat, *counters = self._track(flat, packets, torch.from_numpy(in_round).to(dev),
                                          lanes=self.num_shards)
            totals = counters if totals is None else [a + b for a, b in zip(totals, counters)]
            for i in range(self.num_shards):
                rows = np.flatnonzero(in_round & (lane == i))
                if not rows.shape[0]:
                    continue
                src = np.full(C, n, np.int64)
                src[:rows.shape[0]] = rows
                src_dev = torch.from_numpy(src).to(dev)
                with lane_scope(i):
                    acts = self._decide_pkt(ft.PacketBatch(*(a[src_dev] for a in zero_row)))
                pkt_actions[src_dev[:rows.shape[0]]] = acts[:rows.shape[0]]
        state, out = self._drain_merge(flat, pkt_actions, totals)
        return state, out, rounds

    # ------------------------------------------------------------ host loop
    def _enqueue(self, batch: ft.PacketBatch, host_hash: Optional[np.ndarray],
                 keep: Optional[np.ndarray], keep_dev: Optional[torch.Tensor]):
        """A step's rounds (one at a lane capacity of the batch or a masked
        bucket's, which folds ``keep`` into the partition) and its padding:
        every round dispatches S x ``lane_batch`` lane rows (a bucket: S x the
        bucket), and the kept rows are the batch's packets."""
        S, p = self.num_shards, int(batch.ts.shape[0])
        if self.mesh is not None:
            if host_hash is None:
                host_hash = batch.tuple_hash.cpu().numpy()
            cap = p if keep is not None else self.lane_batch
            self._lane_states, out, rounds = self._lanes_step(self._lane_states, batch,
                                                              host_hash, keep, cap)
            kept = p if keep is None else int(keep.sum())
            return out, rounds, rounds * S * cap - kept
        if keep is not None:
            self.state, out = self._lane_core(self.state, batch, keep_dev)
            return out, 1, S * p - int(keep.sum())
        if self.lane_batch == p:
            self.state, out = self._lane_core(self.state, batch)
            return out, 1, S * p - p
        if host_hash is None:
            host_hash = batch.tuple_hash.cpu().numpy()
        self.state, out, rounds = self._rounds_core(self.state, batch, host_hash)
        return out, rounds, rounds * S * self.lane_batch - p

    # ------------------------------------------------------------- placement
    def plan(self) -> RoutePlan:
        """One RoutePlan across every lane's engines, each lane traced under
        its own ``lane<i>/`` scope (``plan().scoped("lane0")`` is one lane), at
        the lane's shapes: the packet engine at ``lane_batch`` rows, the flow
        engine at ``lane_ready``.  Traced on ``meta`` tensors: nothing runs.

        This is the reference's per-lane placement, not a count of the port's
        launches: where ``lane_batch`` is the batch the port runs the packet
        engine once on the whole batch (the same M, so the same routes), so
        the plan's packet-engine matmuls and ``macs()`` are S times what
        runs; and where rounds are taken, each lane's packet engine runs
        once a non-empty window."""
        use_pkt = self.cfg.pkt_head.needs_logits
        use_flow = self.cfg.flow_head.needs_logits

        def all_lanes(pkt_params, px, flow_params, fx_):
            for i in range(self.num_shards):
                with lane_scope(i):
                    if use_pkt:
                        with name_scope("pkt"):
                            self.packet_engine.fn(pkt_params, px)
                    if use_flow:
                        with name_scope("flow"):
                            self.flow_engine.fn(flow_params, fx_)

        return RoutePlan.trace(
            all_lanes, self.packet_engine.params,
            self.packet_engine.abstract_input(self.lane_batch),
            self.flow_engine.params, self.flow_engine.abstract_input(self.lane_ready),
            config=self.runtime)

    def explain(self) -> str:
        """Placement report of the multi-lane step: the lane topology, the
        composite plan, and each lane's engines."""
        plan = self.plan()
        c = self.cfg
        head = (f"ShardedOctopusPipeline: lanes={self.num_shards} backend={self.backend} "
                f"lane_batch={self.lane_batch} lane_ready={self.lane_ready} "
                f"batch={c.batch_size} max_ready={c.max_ready} flow_model={c.flow_model} "
                f"table={c.table_size}x{self.num_shards} top_n={c.top_n} "
                f"tracker={c.tracker} scan_len={c.scan_len}")
        if c.cold_size:
            head += f" cold={c.cold_size}x{self.num_shards}({c.cold_policy})"
        head += f" heads={c.pkt_head.name}/{c.flow_head.name}"
        lines = [head, plan.explain()]
        for i in range(self.num_shards):
            sub = plan.scoped(f"lane{i}", strip=True)
            lines.append(f"  lane{i}: {len(sub.scoped('pkt'))} pkt + "
                         f"{len(sub.scoped('flow'))} flow matmuls, {sub.macs()} MACs")
        return "\n".join(lines)


__all__ = ["ShardedOctopusPipeline", "LANE_BACKENDS"]
