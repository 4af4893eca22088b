"""Feature extracting domain (paper §3.1): the vectorized (segmented) tracker
update, per-packet model features and the derived whole-feature set.

:func:`segmented_update` merges a whole microbatch into the live
:class:`~repro_torch.core.flow_tracker.TrackerState` in one pass: packets sort
by slot once (stable, so per-flow batch order holds), counts, tuple ids and
the series/payload memories come from rank arithmetic and scatters, and the
feature lanes from the ALU fold :func:`flow_feature_update` (the ``flow_update``
kernel on the card, the plain fold on the CPU), which runs any micro-op
program.  Slots whose batch segment mixes more than one tuple hash take the
scan oracle's values instead, so the result is bit-exact to
:func:`~repro_torch.core.flow_tracker.process_packets` in every case.

:class:`FeatureExtractor` is the offline extractor over one whole trace:
``extract_scan`` (the scan oracle, optionally replaying the feature lanes
through the ALU fold) and ``extract_segmented`` (one segmented merge from an
empty table).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.common.util import Device, resolve_device
from repro_torch.core import flow_tracker as ft
from repro_torch.kernels.flow_features.ops import (
    HIST,
    default_program,
    default_program_np,
    flow_feature_update,
)

INT_MAX = 2**31 - 1
INT_MIN = -(2**31)
FALLBACK_MODES = ("auto", "always", "never")


class SegmentedOut(NamedTuple):
    """Aggregate tracker events of one segmented microbatch merge."""

    new_flows: torch.Tensor  # () int32 — flows established this batch
    evicted: torch.Tensor  # () int32 — stale flows recycled by collision
    fallback_slots: torch.Tensor  # () int32 — slots that took the scan fallback


@dataclass(frozen=True)
class ExtractorConfig:
    table_size: int = 8192  # paper: 8k-depth flow-state table
    top_n: int = 20  # packets per flow tracked for series features
    top_k: int = 15  # packets contributing payload rows
    pay_bytes: int = 16  # payload bytes per packet (paper use-case 3: 16)
    # the reference's switch for its ALU-fold kernel: extract_scan replays
    # the feature lanes through the fold (the flow_update kernel on the
    # card), and the segmented merge takes any micro-op program
    use_pallas: bool = False


def check_default_program(program: torch.Tensor) -> None:
    """Raise unless ``program`` is the default micro-op program: the
    extractor's merge without ``use_pallas`` stands for the reference's
    segment reductions, which hard-code it."""
    if not np.array_equal(program.cpu().numpy(), default_program_np()):
        raise ValueError(
            "segmented_update without use_pallas supports only the default "
            "micro-op program (its feature lanes are segment reductions, not "
            "an ALU replay); set use_pallas=True or use the scan tracker")


def _mixed_segment_heads(s_slot: torch.Tensor, s_hash: torch.Tensor,
                         table_size: int) -> torch.Tensor:
    """(P,) bool over slot-sorted packets — True where a tuple-hash flip
    occurs inside one slot segment (sentinel rows >= table_size excluded).
    The one in-batch collision predicate of :func:`segmented_update` and
    :func:`batch_collisions`."""
    out = torch.zeros(s_slot.shape, dtype=torch.bool, device=s_slot.device)
    out[1:] = ((s_slot[1:] == s_slot[:-1]) & (s_hash[1:] != s_hash[:-1])
               & (s_slot[1:] < table_size))
    return out


def batch_collisions(packets: ft.PacketBatch, table_size: int,
                     keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """() bool — does this (optionally masked) microbatch hold two distinct
    tuple hashes on one slot?  The predicate of the scan fallback."""
    slots = ft.hash_slot(packets.tuple_hash, table_size)
    if keep is not None:
        slots = torch.where(keep, slots, table_size)
    s_slot, order = torch.sort(slots, stable=True)
    return _mixed_segment_heads(s_slot, packets.tuple_hash[order], table_size).any()


def _scatter_drop(table: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
    """``table[rows, cols] = values`` on a copy, dropping entries whose row or
    column is out of range (JAX's ``mode="drop"``): they land in one extra
    element that is sliced off."""
    F, C = table.shape[:2]
    valid = (rows < F) & (cols < C)
    lin = torch.where(valid, rows.long() * C + cols.long(), F * C)
    flat = torch.cat([table.reshape(F * C, *table.shape[2:]),
                      table.new_zeros((1, *table.shape[2:]))])
    flat[lin] = values
    return flat[:-1].view(table.shape)


def segmented_update(state: ft.TrackerState, packets: ft.PacketBatch,
                     program: Optional[torch.Tensor] = None, *, top_n: int,
                     keep: Optional[torch.Tensor] = None, fallback: str = "auto",
                     with_spills: bool = False, lanes: int = 1):
    """Merge a whole microbatch into the live tracker state in one pass,
    bit-identical to scanning it packet by packet.  Returns ``(state,
    SegmentedOut)``, and with ``with_spills`` also the merge's
    :class:`~repro_torch.core.flow_tracker.SpillRecords`, the same as the scan
    oracle's: a non-colliding slot's eviction happens at its segment head, so
    the pre-batch occupant goes to that packet's batch position; colliding
    slots take the fallback's records.  ``state`` is read, never written (the
    records read its rows after the fold).

    ``keep`` (optional (P,) bool) drops packets without changing shapes:
    dropped packets sort to the sentinel slot F, which every reduction and
    scatter ignores.  ``fallback`` controls the collision branch: ``"auto"``
    runs the scan oracle for colliding slots only when the batch has an
    in-batch collision, ``"always"``/``"never"`` decide statically
    (``"never"`` is exact only for collision-free batches).

    ``lanes`` makes ``state`` a bank of that many lanes
    (:func:`~repro_torch.core.flow_tracker.lane_slot`): one merge, one
    collision check and one fold for every lane.  A tuple's packets stay in
    its lane and in batch order, so each lane ends as if it had merged its
    own packets alone; a fallback taken for one lane's collision is exact for
    the others too."""
    if fallback not in FALLBACK_MODES:
        raise ValueError(f"fallback must be one of {FALLBACK_MODES}, got {fallback!r}")
    dev = state.count.device
    if program is None:
        program = default_program(dev)
    F = state.tuple_id.shape[0]
    P = packets.ts.shape[0]
    if keep is None:
        keep = torch.ones(P, dtype=torch.bool, device=dev)

    slots = ft.lane_slot(packets.tuple_hash, F, lanes)
    slots_eff = torch.where(keep, slots, F).to(torch.int32)
    s_slot, order = torch.sort(slots_eff, stable=True)
    s = ft.PacketBatch(*(a[order] for a in packets))
    s_idx = s_slot.long()

    first = torch.ones(P, dtype=torch.bool, device=dev)
    first[1:] = s_slot[1:] != s_slot[:-1]
    counts_ext = torch.bincount(s_idx, minlength=F + 1)  # [F] counts dropped packets
    counts_b = counts_ext[:F].to(torch.int32)
    touched = counts_b > 0

    mixed = _mixed_segment_heads(s_slot, s.tuple_hash, F)
    collide = torch.zeros(F + 1, dtype=torch.int32, device=dev).scatter_reduce_(
        0, s_idx, mixed.to(torch.int32), "amax")[:F] > 0

    # single-hash segments: any reduction of equal values recovers the hash
    # (an empty segment reads INT_MIN, as jax.ops.segment_max fills it)
    h_f = torch.full((F + 1,), INT_MIN, dtype=torch.int32, device=dev).scatter_reduce_(
        0, s_idx, s.tuple_hash, "amax")[:F]
    occupied = state.count > 0
    hit = touched & occupied & (state.tuple_id == h_f)
    establish = touched & ~hit  # first packet of the segment establishes
    evicted_f = touched & occupied & ~hit

    count0 = torch.where(hit, state.count, 0)
    est = establish[:, None]
    feats_base = torch.where(est, ft.fresh_feature_word(dev), state.features)
    series_base = torch.where(est, 0, state.series)
    sizes_base = torch.where(est, 0, state.sizes)
    pay_base = torch.where(est[:, :, None], 0, state.payload)

    # inter-arrival per packet: within the segment from the previous packet,
    # at the segment head from the live flow's last_ts (0 at establish)
    pad = lambda t, v: torch.cat([t, t.new_full((1,), v)])  # row F for dropped packets
    prev_ts = torch.cat([s.ts.new_zeros(1), s.ts[:-1]])
    head_intv = torch.where(pad(hit, False)[s_idx],
                            s.ts - pad(state.last_ts, 0)[s_idx], 0)
    intv = torch.where(first, head_intv, s.ts - prev_ts).to(torch.int32)

    start = torch.cumsum(counts_ext, 0) - counts_ext
    rank = torch.arange(P, device=dev) - start[s_idx]
    g_rank = pad(count0, 0)[s_idx] + rank  # per-flow packet index incl. history
    last_idx = torch.clamp(torch.cumsum(counts_ext[:F], 0) - 1, 0, max(P - 1, 0))

    # the ALU fold (establish resets are pre-applied in feats_base; dropped
    # packets carry slot F and touch no row; colliding slots are overwritten
    # by the fallback below)
    feats = flow_feature_update(program, s_slot, ft.build_meta(s, intv), feats_base)

    # series/payload memories by per-flow rank; overflow ranks are dropped
    # (never overwrite the oldest stored packets — oracle semantics)
    series = _scatter_drop(series_base, s_idx, g_rank, intv)
    sizes = _scatter_drop(sizes_base, s_idx, g_rank, s.size)
    payload = _scatter_drop(pay_base, s_idx, g_rank, s.payload)

    seg_state = ft.TrackerState(
        tuple_id=torch.where(touched, h_f, state.tuple_id),
        count=torch.where(touched, count0 + counts_b, state.count),
        last_ts=torch.where(touched, s.ts[last_idx], state.last_ts),
        features=feats, series=series, sizes=sizes, payload=payload)
    new_flows = (establish & ~collide).sum().to(torch.int32)
    evicted = (evicted_f & ~collide).sum().to(torch.int32)
    spills = _head_spills(state, s_slot, order, first, evicted_f) if with_spills else None

    if fallback == "always" or (fallback == "auto" and bool(collide.any())):
        scan = ft.process_packets(state, packets, program, top_n=top_n, keep=keep,
                                  with_spills=with_spills, lanes=lanes)
        scan_state, outs = scan[:2]

        def pick(mask: torch.Tensor, seg_leaf: torch.Tensor,
                 scan_leaf: torch.Tensor) -> torch.Tensor:
            return torch.where(mask.view(-1, *[1] * (seg_leaf.dim() - 1)), scan_leaf, seg_leaf)

        seg_state = ft.TrackerState(*(pick(collide, a, b) for a, b in zip(seg_state, scan_state)))
        pkt_collides = collide[slots.long()]  # original batch order
        new_flows = new_flows + (outs.new_flow & pkt_collides).sum().to(torch.int32)
        evicted = evicted + (outs.evicted & pkt_collides).sum().to(torch.int32)
        if with_spills:
            spills = ft.SpillRecords(*(pick(pkt_collides, a, b)
                                       for a, b in zip(spills, scan[2])))
    out = SegmentedOut(new_flows=new_flows, evicted=evicted,
                       fallback_slots=collide.sum().to(torch.int32))
    return (seg_state, out, spills) if with_spills else (seg_state, out)


def _head_spills(state: ft.TrackerState, s_slot: torch.Tensor, order: torch.Tensor,
                 first: torch.Tensor, evicted_f: torch.Tensor) -> ft.SpillRecords:
    """The spill records of the non-colliding slots: each evicting segment
    head's pre-batch occupant at the head's batch position.  Non-heads write
    a scratch row P that is sliced off, so nothing waits on the host."""
    F, P = state.tuple_id.shape[0], s_slot.shape[0]
    live = s_slot < F
    safe = torch.where(live, s_slot, 0).long()
    ev_head = first & live & evicted_f[safe]
    pos = torch.where(ev_head, order, P)
    rec = ft.empty_spills(state, P + 1)
    rec.mask[pos] = ev_head
    rec.slot[pos] = torch.where(ev_head, s_slot, F).to(torch.int32)
    for name in ("tuple_id", "count", "last_ts", "features", "series", "sizes", "payload"):
        rows = getattr(state, name)[safe]
        getattr(rec, name)[pos] = torch.where(
            ev_head.view(-1, *[1] * (rows.dim() - 1)), rows, 0)
    return ft.SpillRecords(*(leaf[:P] for leaf in rec))


class FeatureExtractor:
    """The offline extractor over a table of ``cfg.table_size`` slots on
    ``device`` (the card unless another is named)."""

    def __init__(self, cfg: ExtractorConfig = ExtractorConfig(),
                 program: Optional[torch.Tensor] = None, *, device: Device = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.program = (default_program(self.device) if program is None
                        else program.to(self.device))
        self._custom = not np.array_equal(self.program.cpu().numpy(), default_program_np())

    def init_state(self) -> ft.TrackerState:
        c = self.cfg
        return ft.init_state(c.table_size, c.top_n, c.top_k, c.pay_bytes, device=self.device)

    def extract_scan(self, state: ft.TrackerState, packets: ft.PacketBatch):
        """The order-exact oracle (:func:`~repro_torch.core.flow_tracker.
        process_packets`).  Under ``use_pallas`` the feature table is then
        recomputed by replaying the ALU fold (one ``flow_update`` launch on
        the card) over each slot's packets since its last establish, and
        replaces the scanned one: identical by construction, so the fold runs
        on the real establish/evict stream.  The rest of the state (counts,
        series, payload, tuple ids) always comes from the scan."""
        state2, outs = ft.process_packets(state, packets, self.program, top_n=self.cfg.top_n)
        if not self.cfg.use_pallas:
            return state2, outs
        feats = flow_feature_update(self.program, *self.replay_inputs(state, packets, outs))
        return state2._replace(features=feats), outs

    def replay_inputs(self, state: ft.TrackerState, packets: ft.PacketBatch, outs: ft.StepOut
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The replay's fold inputs ``(slots, meta, table)`` after the scan of
        ``packets`` from ``state`` gave ``outs``: a flow's word holds only
        the packets since its slot's last establish (each establish resets
        it), so the packets before it go to the dropped slot F, and a slot
        that establishes starts from the fresh word."""
        p, f = packets.ts.shape[0], state.tuple_id.shape[0]
        pos = torch.arange(p, dtype=torch.int32, device=self.device)
        last_est = torch.full((f,), -1, dtype=torch.int32, device=self.device).scatter_reduce(
            0, outs.slot.long(), torch.where(outs.new_flow, pos, -1), "amax")
        keep = pos >= last_est[outs.slot.long()]
        table = torch.where((last_est >= 0)[:, None], ft.fresh_feature_word(self.device),
                            state.features)
        slots = torch.where(keep, outs.slot, f).to(torch.int32)
        return slots, ft.build_meta(packets, outs.arv_intv), table

    def segmented_update(self, state: ft.TrackerState, packets: ft.PacketBatch):
        """The vectorized merge into live state (:func:`segmented_update`);
        without ``use_pallas`` only the default program is taken, as the
        reference's segment reductions take only it."""
        if self._custom and not self.cfg.use_pallas:
            check_default_program(self.program)
        return segmented_update(state, packets, self.program, top_n=self.cfg.top_n)

    def extract_segmented(self, packets: ft.PacketBatch):
        """A whole batch merged into an empty table: (features (F, 16),
        series (F, top_n), sizes, payload, counts (F,)), exact against the
        scan oracle, in-batch slot collisions included."""
        state, _ = self.segmented_update(self.init_state(), packets)
        return state.features, state.series, state.sizes, state.payload, state.count


def derive_whole_features(feats: torch.Tensor) -> torch.Tensor:
    """The float 'whole feature set' vector (Table 7 core subset) from the
    16-lane history register: (..., 16) int32 -> (..., 12) float32."""
    f = feats.float()
    count = torch.clamp_min(f[..., HIST["pkt_count"]], 1.0)
    dur = f[..., HIST["flow_dur"]]
    size = f[..., HIST["flow_size"]]
    no_min = lambda lane: torch.where(f[..., lane] >= INT_MAX, 0.0, f[..., lane])
    return torch.stack([
        dur,  # flow duration time
        f[..., HIST["pkt_count"]],  # total packets
        size,  # flow size
        size / count,  # mean packet length
        f[..., HIST["max_size"]],
        no_min(HIST["min_size"]),
        f[..., HIST["max_intv"]],
        no_min(HIST["min_intv"]),
        dur / count,  # mean inter-arrival
        f[..., HIST["size_fwd"]],
        f[..., HIST["size_bwd"]],
        f[..., HIST["flags_acc"]],
    ], dim=-1)


def packet_meta_features(packets: ft.PacketBatch) -> torch.Tensor:
    """Per-packet feature vector for packet-granularity models (use-case 1's
    six-dimension input: size, direction, flags, proto, payload_len, intv=0)."""
    pay_len = torch.clamp_max(packets.size, packets.payload.shape[-1])
    return torch.stack([
        packets.size.float(), packets.dir.float(), packets.flags.float(),
        packets.proto.float(), pay_len.float(), torch.zeros_like(packets.size, dtype=torch.float32),
    ], dim=-1)
