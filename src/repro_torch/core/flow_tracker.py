"""Flow tracker (paper §3.1): hash-indexed flow-state establishment, update,
and freeing, with ready-flow emission at the top-n packet threshold.

State per slot: the flow's 5-tuple hash ``tuple_id``, the packet ``count``,
the latest timestamp ``last_ts``, the 16-lane history register ``features``,
the per-flow vector memories ``series``/``sizes`` (top-n arrival intervals /
packet sizes) and the ``payload`` matrix (top-k packets x pay_bytes).  A new
tuple hashing onto an occupied slot evicts the stale flow.

JAX's ``.at[...].set(..., mode="drop")`` scatters with the ``table_size``
sentinel become writes into one extra sentinel row that is sliced off, since
torch indexing raises on an out-of-range index.

**Lanes.**  The sharded pipeline keeps S lanes of F slots as one bank of
S·F rows (lane-major, so the (S, F, ...) stack is a view of it).  Every
function here that hashes takes ``lanes`` (default 1): a tuple's row is
:func:`lane_slot`, its lane's base plus its slot in that lane, so two tuples
share a row only when they share a lane, and one merge, drain or fold runs
every lane at once.  Inside such a bank the sentinel is S·F.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.common.util import Device, resolve_device, segment_ranks
from repro_torch.kernels.flow_features.ops import HIST, apply_alu_program

INT_MAX = 2**31 - 1
_MIN_LANES = (HIST["min_size"], HIST["min_intv"])  # running minima start at INT_MAX
_GOLDEN = 0x9E3779B1


class TrackerState(NamedTuple):
    tuple_id: torch.Tensor  # (F,) int32
    count: torch.Tensor  # (F,) int32
    last_ts: torch.Tensor  # (F,) int32
    features: torch.Tensor  # (F, 16) int32
    series: torch.Tensor  # (F, top_n) int32  (arrival-interval vector memory)
    sizes: torch.Tensor  # (F, top_n) int32  (packet-size vector memory)
    payload: torch.Tensor  # (F, top_k, pay_bytes) int32


class PacketBatch(NamedTuple):
    """Struct-of-arrays packet records (the parser's output, §3.1 step 1)."""

    ts: torch.Tensor  # (P,) int32 microseconds
    size: torch.Tensor  # (P,) int32
    dir: torch.Tensor  # (P,) int32 0/1
    flags: torch.Tensor  # (P,) int32
    proto: torch.Tensor  # (P,) int32
    tuple_hash: torch.Tensor  # (P,) int32 hash of the 5-tuple
    payload: torch.Tensor  # (P, pay_bytes) int32 (truncated payload)


def fresh_feature_word(device: Device = None) -> torch.Tensor:
    w = torch.zeros(16, dtype=torch.int32, device=resolve_device(device))
    w[list(_MIN_LANES)] = INT_MAX
    return w


def init_state(table_size: int, top_n: int, top_k: int, pay_bytes: int, *,
               device: Device = None) -> TrackerState:
    dev = resolve_device(device)
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=dev)
    return TrackerState(
        tuple_id=z(table_size), count=z(table_size), last_ts=z(table_size),
        features=fresh_feature_word(dev).repeat(table_size, 1),
        series=z(table_size, top_n), sizes=z(table_size, top_n),
        payload=z(table_size, top_k, pay_bytes))


def hash_slot(tuple_hash: torch.Tensor, table_size: int) -> torch.Tensor:
    """Multiplicative hash onto the flow table: the uint32 product
    ``hash * 0x9E3779B1`` (mod 2**32), folded by ``h ^ (h >> 16)``.  The
    product is formed from 16-bit halves in int64, so nothing overflows."""
    h = tuple_hash.to(torch.int64) & 0xFFFFFFFF
    lo, hi = h & 0xFFFF, h >> 16
    h = (lo * _GOLDEN + (((hi * _GOLDEN) & 0xFFFF) << 16)) & 0xFFFFFFFF
    h = h ^ (h >> 16)
    return (h % table_size).to(torch.int32)


def shard_of(tuple_hash, num_shards: int):
    """Lane assignment ``tuple_hash % num_shards`` through uint32, so a flow's
    packets always land in one lane and negative int32 hashes agree between
    the host and the device.  Takes a tensor (int32 result on its device), a
    numpy array (int32) or a python int."""
    if isinstance(tuple_hash, (int, np.integer)):
        return int((int(tuple_hash) & 0xFFFFFFFF) % num_shards)
    if isinstance(tuple_hash, np.ndarray):
        return (tuple_hash.astype(np.uint32) % np.uint32(num_shards)).astype(np.int32)
    return ((tuple_hash.to(torch.int64) & 0xFFFFFFFF) % num_shards).to(torch.int32)


def lane_row(lane, slot, lane_rows: int) -> torch.Tensor:
    """Row ``lane * lane_rows + slot`` of a lane-major bank of lanes of
    ``lane_rows`` rows (int32): the one place a lane's base is added."""
    return (lane * lane_rows + slot).to(torch.int32)


def lane_of(row, lane_rows: int):
    """The lane of a row of a lane-major bank of lanes of ``lane_rows``
    rows: the inverse of :func:`lane_row`."""
    return row // lane_rows


def lane_slot(tuple_hash: torch.Tensor, rows: int, lanes: int = 1) -> torch.Tensor:
    """A tuple's row in a bank of ``rows`` = lanes x F rows:
    ``shard_of(h, lanes) * F + hash_slot(h, F)`` (int32); one lane is
    :func:`hash_slot` itself."""
    if lanes == 1:
        return hash_slot(tuple_hash, rows)
    if rows % lanes:
        raise ValueError(f"a bank of {rows} rows does not split into {lanes} lanes")
    f = rows // lanes
    return lane_row(shard_of(tuple_hash, lanes), hash_slot(tuple_hash, f), f)


def hash_slot_scalar(tuple_hash: int, table_size: int) -> int:
    """:func:`hash_slot` for one host-side int (the traffic generator's
    collision avoidance)."""
    h = ((tuple_hash & 0xFFFFFFFF) * _GOLDEN) & 0xFFFFFFFF
    h ^= h >> 16
    return int(h % table_size)


def build_meta(pkt: PacketBatch, arv_intv: torch.Tensor) -> torch.Tensor:
    """The meta registers (paper Table 2) of a batch of packets: (P, 13)."""
    size = pkt.size
    zero = torch.zeros_like(size)
    cols = [
        size,  # pkt_size
        arv_intv,
        pkt.dir,
        pkt.flags,
        pkt.ts,
        torch.clamp_max(size, pkt.payload.shape[-1]),  # payload_len
        torch.ones_like(size),  # one
        zero,
        torch.where(pkt.dir == 0, size, zero),  # size_fwd
        torch.where(pkt.dir == 1, size, zero),  # size_bwd
        -size,
        -arv_intv,
        pkt.proto,
    ]
    return torch.stack(cols, dim=-1).to(torch.int32)


class StepOut(NamedTuple):
    slot: torch.Tensor  # (P,) int32; table_size for dropped packets
    ready: torch.Tensor  # flow hit top_n with this packet
    new_flow: torch.Tensor
    evicted: torch.Tensor
    arv_intv: torch.Tensor  # inter-arrival time seen by the tracker (0 at establish)


class SpillRecords(NamedTuple):
    """One row per batch packet: the flow state an eviction overwrote, read
    before the establishing write (the cold store's insert feed).  Rows with
    ``mask == False`` are padding (slot == table_size, data zeros); the scan
    and segmented trackers emit the same records."""

    mask: torch.Tensor  # (P,) bool — this packet evicted a live flow
    slot: torch.Tensor  # (P,) int32; table_size for padding rows
    tuple_id: torch.Tensor  # (P,) int32
    count: torch.Tensor  # (P,) int32
    last_ts: torch.Tensor  # (P,) int32
    features: torch.Tensor  # (P, 16) int32
    series: torch.Tensor  # (P, top_n) int32
    sizes: torch.Tensor  # (P, top_n) int32
    payload: torch.Tensor  # (P, top_k, pay_bytes) int32


def empty_spills(state: TrackerState, p: int) -> SpillRecords:
    """``p`` padding rows shaped like ``state``'s leaves."""
    z = lambda leaf: leaf.new_zeros((p, *leaf.shape[1:]))
    return SpillRecords(
        mask=torch.zeros(p, dtype=torch.bool, device=state.count.device),
        slot=torch.full((p,), state.tuple_id.shape[0], dtype=torch.int32,
                        device=state.count.device),
        tuple_id=z(state.tuple_id), count=z(state.count), last_ts=z(state.last_ts),
        features=z(state.features), series=z(state.series), sizes=z(state.sizes),
        payload=z(state.payload))


def process_packets(state: TrackerState, packets: PacketBatch, program: torch.Tensor,
                    *, top_n: int, keep: Optional[torch.Tensor] = None,
                    with_spills: bool = False, lanes: int = 1):
    """Order-exact oracle: the FPGA's serial per-packet semantics.

    Only packets of one slot depend on each other, so packets sort by slot
    (stable) and run round by round: round r applies the r-th packet of every
    slot at once.  A packet with ``keep == False`` is a complete no-op on the
    table and its :class:`StepOut` row is neutral (slot == table_size, all
    flags False).  Returns ``(state, StepOut)``; with ``with_spills`` also the
    :class:`SpillRecords`, each evicted occupant read in its round before the
    round writes its slot.  ``lanes`` splits the table into a lane bank
    (:func:`lane_slot`)."""
    F = state.tuple_id.shape[0]
    top_k = state.payload.shape[1]
    P = packets.ts.shape[0]
    dev = state.count.device
    if keep is None:
        keep = torch.ones(P, dtype=torch.bool, device=dev)
    slots = lane_slot(packets.tuple_hash, F, lanes)
    slot_eff = torch.where(keep, slots, F)
    s_slot, order = torch.sort(slot_eff, stable=True)
    n_kept = int(keep.sum())
    rank = segment_ranks(s_slot)[:n_kept]
    order = order[:n_kept]
    st = TrackerState(*(leaf.clone() for leaf in state))
    fresh = fresh_feature_word(dev)

    ready = torch.zeros(P, dtype=torch.bool, device=dev)
    new_flow = torch.zeros_like(ready)
    evicted = torch.zeros_like(ready)
    arv_out = torch.zeros(P, dtype=torch.int32, device=dev)
    spills = empty_spills(state, P) if with_spills else None
    rounds = int(rank.max()) + 1 if n_kept else 0
    for r in range(rounds):
        sel = order[rank == r]  # batch positions; their slots are distinct
        sl = slots[sel].long()
        pkt = PacketBatch(*(a[sel] for a in packets))
        occupied = st.count[sl] > 0
        hit = occupied & (st.tuple_id[sl] == pkt.tuple_hash)
        is_new = ~hit
        count0 = torch.where(hit, st.count[sl], 0)
        feats0 = torch.where(is_new[:, None], fresh, st.features[sl])
        series0 = torch.where(is_new[:, None], 0, st.series[sl])
        sizes0 = torch.where(is_new[:, None], 0, st.sizes[sl])
        pay0 = torch.where(is_new[:, None, None], 0, st.payload[sl])

        arv = torch.where(count0 > 0, pkt.ts - st.last_ts[sl], 0).to(torch.int32)
        if with_spills:  # the occupant, before this round's writes below
            ev = occupied & ~hit
            spills.mask[sel] = ev
            spills.slot[sel] = torch.where(ev, sl, F).to(torch.int32)
            for name in ("tuple_id", "count", "last_ts", "features", "series", "sizes",
                         "payload"):
                rows = getattr(st, name)[sl]
                getattr(spills, name)[sel] = torch.where(
                    ev.view(-1, *[1] * (rows.dim() - 1)), rows, 0)
        feats1 = apply_alu_program(program, build_meta(pkt, arv), feats0)
        # the vector memories keep the first top_n / top_k packets
        row = torch.arange(sel.shape[0], device=dev)
        w_n = count0 < top_n
        idx = torch.clamp_max(count0, top_n - 1).long()
        series0[row, idx] = torch.where(w_n, arv, series0[row, idx])
        sizes0[row, idx] = torch.where(w_n, pkt.size, sizes0[row, idx])
        kidx = torch.clamp_max(count0, top_k - 1).long()
        pay0[row, kidx] = torch.where((count0 < top_k)[:, None], pkt.payload,
                                      pay0[row, kidx])
        count1 = (count0 + 1).to(torch.int32)

        st.tuple_id[sl] = pkt.tuple_hash
        st.count[sl] = count1
        st.last_ts[sl] = pkt.ts
        st.features[sl] = feats1
        st.series[sl] = series0
        st.sizes[sl] = sizes0
        st.payload[sl] = pay0
        ready[sel] = count1 == top_n
        new_flow[sel] = is_new
        evicted[sel] = occupied & ~hit
        arv_out[sel] = arv
    out = StepOut(slot=slot_eff.to(torch.int32), ready=ready, new_flow=new_flow,
                  evicted=evicted, arv_intv=arv_out)
    return (st, out, spills) if with_spills else (st, out)


def _row_mask(slots: torch.Tensor, table_size: int) -> torch.Tensor:
    """(F,) bool: rows named in ``slots``; the sentinel ``table_size`` names
    none."""
    mask = torch.zeros(table_size + 1, dtype=torch.bool, device=slots.device)
    mask[slots.long()] = True
    return mask[:table_size]


def _recycle(state: TrackerState, rows: torch.Tensor) -> TrackerState:
    """Reset the rows where ``rows`` (F,) is True to a fresh slot: every one
    of the seven leaves, so no stale value reaches the next flow there."""
    def clear(leaf: torch.Tensor, fill) -> torch.Tensor:
        return torch.where(rows.view(-1, *[1] * (leaf.dim() - 1)), fill, leaf)

    fresh = fresh_feature_word(rows.device)
    return TrackerState(
        tuple_id=clear(state.tuple_id, 0), count=clear(state.count, 0),
        last_ts=clear(state.last_ts, 0), features=clear(state.features, fresh),
        series=clear(state.series, 0), sizes=clear(state.sizes, 0),
        payload=clear(state.payload, 0))


def release_flows(state: TrackerState, slots: torch.Tensor) -> TrackerState:
    """FIN handling: recycle these slots (``table_size`` entries are padding
    and recycle nothing)."""
    return _recycle(state, _row_mask(slots, state.tuple_id.shape[0]))


class DrainResult(NamedTuple):
    """Up to ``max_ready`` emitted ready flows, fixed shapes (R = max_ready).
    Rows with ``mask == False`` are padding (slot == table_size, zeros)."""

    slots: torch.Tensor  # (R,) int32; table_size for padding rows
    mask: torch.Tensor  # (R,) bool — row holds a real emitted flow
    tuple_id: torch.Tensor  # (R,) int32
    count: torch.Tensor  # (R,) int32 (>= top_n wherever mask)
    features: torch.Tensor  # (R, 16) int32
    series: torch.Tensor  # (R, top_n) int32
    sizes: torch.Tensor  # (R, top_n) int32
    payload: torch.Tensor  # (R, top_k, pay_bytes) int32


def ready_mask(state: TrackerState, *, top_n: int) -> torch.Tensor:
    """(F,) bool — flows that have delivered their top-n packets and await
    emission (the in-flight FIFO contents, §3.1)."""
    return state.count >= top_n


def drain_ready(state: TrackerState, *, top_n: int, max_ready: int, lanes: int = 1
                ) -> tuple[TrackerState, DrainResult]:
    """Read out up to ``max_ready`` flows whose ``count >= top_n``, lowest
    slots first, and recycle their table entries.  Flows beyond
    ``max_ready`` stay ready and drain on a later call.

    In a bank of ``lanes`` lanes each lane drains up to ``max_ready / lanes``
    of its own flows, lowest slots first, and the rows come out lane-major
    with lane-local slots (padding: the lane's size F), as one lane's drain
    each, concatenated."""
    rows = state.tuple_id.shape[0]
    if max_ready % lanes or rows % lanes:
        raise ValueError(f"max_ready={max_ready} and the {rows}-row bank must split into "
                         f"{lanes} lanes")
    F, R = rows // lanes, max_ready // lanes
    if not 0 < R <= F:
        raise ValueError(f"max_ready must be in [1, {F}], got {max_ready}")
    dev = state.count.device
    ready = ready_mask(state, top_n=top_n).view(lanes, F)
    keys = torch.where(ready, torch.arange(F, dtype=torch.int32, device=dev), F)
    slots = torch.topk(keys, R, dim=1, largest=False, sorted=True).values.reshape(-1)
    mask = slots < F
    lane = torch.arange(lanes, device=dev).repeat_interleave(R)
    safe = torch.where(mask, lane_row(lane, slots, F), 0).long()

    def emit(leaf: torch.Tensor) -> torch.Tensor:
        m = mask.view(max_ready, *[1] * (leaf.dim() - 1))
        return torch.where(m, leaf[safe], 0)

    out = DrainResult(
        slots=torch.where(mask, slots, F).to(torch.int32), mask=mask,
        tuple_id=emit(state.tuple_id), count=emit(state.count),
        features=emit(state.features), series=emit(state.series),
        sizes=emit(state.sizes), payload=emit(state.payload))
    return release_flows(state, torch.where(mask, safe, rows)), out
