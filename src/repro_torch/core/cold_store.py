"""Second-level (cold) flow table: the spill/promote half of the two-level
tracker, for flow populations far past the hot table (10^5-10^6 flows).

The hot level is the plain :class:`~repro_torch.core.flow_tracker.TrackerState`
bank, unchanged (with ``cold_size == 0`` the pipeline never touches this
module).  Collision evictions spill into a large :class:`ColdState` table and
re-establishment promotes from it:

  * **2-choice hashing** — every tuple hash owns two cold candidate slots
    (:func:`cold_slots`); an insert takes the slot already holding the tuple,
    then an empty slot (the first candidate wins ties), and only then evicts
    the candidate with the smaller policy stamp.
  * **eviction policy** — ``"age"`` stamps an entry with the spilled flow's
    ``last_ts``, ``"lru"`` with the insert tick (the count of inserts before).

A two-level step, in order: :func:`promote_pass` (segment heads in ascending
hot-slot order load their tuple back from cold; a displaced hot occupant
spills first), the tracker merge with spill records, :func:`apply_spills`
(the records insert in packet order) and :func:`scrub_live` (no tuple live
in hot stays in cold).

The walks are sequential in their semantics but run in rounds: records whose
cold slots no earlier pending record touches go together, since their
reads and writes are disjoint (:func:`_rounds`).  Ordinary traffic finishes
in one round; only records that share a slot with an earlier one wait.  A
round is a fixed handful of tensor ops, never a launch per record, and each
costs the host one wait (for its records' indices), after one for the count
of records.

Every function here writes the leaves it is given in place, with indexed
writes whose size follows the batch, never the table: the pipeline owns its
state, and a copy of a 2^20-entry cold bank would cost more than the step.

**Lanes.**  With ``lanes`` S > 1 the hot table is a bank of S lanes
(:func:`~repro_torch.core.flow_tracker.lane_slot`) and the cold table one of
S lanes of C entries, lane-major, with one insert ``tick`` a lane ((S,)):
a tuple's cold candidates lie in its own lane, so lanes never touch each
other's entries, and under ``lru`` each lane stamps with its own clock.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple, Optional

import torch

from repro_torch.common.util import Device, resolve_device
from repro_torch.core import flow_tracker as ft

COLD_POLICIES = ("age", "lru")
_MIX_A, _MIX_B = 0x85EBCA6B, 0xC2B2AE35  # murmur3 finalizer constants
_WIDE = ("features", "series", "sizes", "payload")


class ColdState(NamedTuple):
    """The cold table: one entry per slot, ``count == 0`` means empty; the
    leaves of :class:`~repro_torch.core.flow_tracker.TrackerState` plus the
    eviction ``stamp`` and the insert ``tick``."""

    tuple_id: torch.Tensor  # (C,) int32
    count: torch.Tensor  # (C,) int32 — 0 == empty
    last_ts: torch.Tensor  # (C,) int32
    features: torch.Tensor  # (C, 16) int32
    series: torch.Tensor  # (C, top_n) int32
    sizes: torch.Tensor  # (C, top_n) int32
    payload: torch.Tensor  # (C, top_k, pay_bytes) int32
    stamp: torch.Tensor  # (C,) int32 — eviction key (policy-defined)
    tick: torch.Tensor  # () int32 — inserts so far (the lru clock); (S,) in a lane bank


class TwoLevelState(NamedTuple):
    """The pipeline's tracker state when ``cold_size > 0``."""

    hot: ft.TrackerState
    cold: ColdState


def init_cold(cold_size: int, top_n: int, top_k: int, pay_bytes: int, *,
              device: Device = None) -> ColdState:
    dev = resolve_device(device)
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=dev)
    return ColdState(tuple_id=z(cold_size), count=z(cold_size), last_ts=z(cold_size),
                     features=z(cold_size, 16), series=z(cold_size, top_n),
                     sizes=z(cold_size, top_n), payload=z(cold_size, top_k, pay_bytes),
                     stamp=z(cold_size), tick=z())


def init_two_level(table_size: int, cold_size: int, top_n: int, top_k: int,
                   pay_bytes: int, *, device: Device = None) -> TwoLevelState:
    return TwoLevelState(
        hot=ft.init_state(table_size, top_n, top_k, pay_bytes, device=device),
        cold=init_cold(cold_size, top_n, top_k, pay_bytes, device=device))


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c`` mod 2^32 for h in [0, 2^32), from 16-bit halves in int64."""
    lo, hi = h & 0xFFFF, h >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & 0xFFFFFFFF


def cold_slots(tuple_hash: torch.Tensor, cold_size: int, lanes: int = 1,
               lane: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The tuple's two cold candidate slots (int32): two multiplicative
    mixers on the uint32 hash, ``a = h * 0x85EBCA6B; a ^= a >> 13`` and
    ``b = h * 0xC2B2AE35; b ^= b >> 16`` mod 2^32, each mod ``cold_size``,
    apart from the hot table's :func:`~repro_torch.core.flow_tracker.hash_slot`
    so hot and cold collisions do not correlate.  In a bank of ``lanes``
    lanes of ``cold_size / lanes`` entries both lie in the tuple's lane
    (``lane``, by default ``shard_of(h, lanes)``)."""
    c = cold_size // lanes
    h = tuple_hash.to(torch.int64) & 0xFFFFFFFF
    a = _mul32(h, _MIX_A)
    b = _mul32(h, _MIX_B)
    a = a ^ (a >> 13)
    b = b ^ (b >> 16)
    a, b = (a % c).to(torch.int32), (b % c).to(torch.int32)
    if lanes == 1:
        return a, b
    if lane is None:
        lane = ft.shard_of(tuple_hash, lanes)
    return ft.lane_row(lane, a, c), ft.lane_row(lane, b, c)


def cold_slots_scalar(tuple_hash: int, cold_size: int) -> tuple[int, int]:
    """:func:`cold_slots` for one host-side int."""
    a = ((tuple_hash & 0xFFFFFFFF) * _MIX_A) & 0xFFFFFFFF
    a ^= a >> 13
    b = ((tuple_hash & 0xFFFFFFFF) * _MIX_B) & 0xFFFFFFFF
    b ^= b >> 16
    return int(a % cold_size), int(b % cold_size)


def _check_policy(policy: str) -> None:
    if policy not in COLD_POLICIES:
        raise ValueError(f"policy must be one of {COLD_POLICIES}, got {policy!r}")


def _lane_stamps(tick: torch.Tensor, lane: torch.Tensor, inserts: torch.Tensor,
                 lanes: int) -> torch.Tensor:
    """Each record's insert tick: its lane's ``tick`` plus the ``inserts``
    ((R,) bool) of its lane before it (int32)."""
    ins = inserts.to(torch.int64)
    if lanes == 1:
        before = torch.cumsum(ins, 0) - ins
    else:
        mine = torch.nn.functional.one_hot(lane.long(), lanes) * ins[:, None]
        before = (torch.cumsum(mine, 0) - mine).gather(1, lane.long()[:, None]).squeeze(1)
    return (tick.reshape(-1)[lane.long()] + before).to(torch.int32)


def _advance(cold: ColdState, lane: torch.Tensor, inserts: torch.Tensor, lanes: int) -> None:
    """Each lane's ``tick`` += its ``inserts``, in place."""
    per_lane = torch.zeros(lanes, dtype=torch.int32, device=inserts.device).index_add_(
        0, lane.long(), inserts.to(torch.int32))
    cold.tick.add_(per_lane.view(cold.tick.shape))


def _choose_slot(cold: ColdState, h: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Insert destination of tuples ``h`` with candidates ``a``/``b`` (int64):
    its own entry if present, else the first empty candidate, else the one
    with the smaller stamp (a tie takes ``a``)."""
    occ_a, occ_b = cold.count[a] > 0, cold.count[b] > 0
    match_a = occ_a & (cold.tuple_id[a] == h)
    match_b = occ_b & (cold.tuple_id[b] == h)
    victim = torch.where(cold.stamp[a] <= cold.stamp[b], a, b)
    return torch.where(match_a, a, torch.where(match_b, b, torch.where(
        ~occ_a, a, torch.where(~occ_b, b, victim))))


def _rounds(touch: torch.Tensor, active: torch.Tensor) -> Iterator[torch.Tensor]:
    """Yield the indices of the ``active`` records round by round, each
    record after every earlier active record that shares one of its cold
    slots (``touch`` (R, k) int64), and the records of one round on
    pairwise disjoint slots.  A record is ready once it is the earliest
    pending record on each of its slots.  The host waits once for the count
    of records and once a round."""
    r, k = touch.shape
    n_left = int(active.sum())
    if not n_left:
        return
    dev = touch.device
    s_slot, perm = torch.sort(touch.reshape(-1))
    s_rec = torch.arange(r, device=dev).repeat_interleave(k)[perm]
    new = torch.ones_like(s_slot, dtype=torch.bool)
    new[1:] = s_slot[1:] != s_slot[:-1]
    gid = torch.cumsum(new, 0) - 1
    pending = active.clone()
    while n_left:
        pend = pending[s_rec]
        first = torch.full((r * k,), r, dtype=torch.int64, device=dev).scatter_reduce_(
            0, gid, torch.where(pend, s_rec, r), "amin")
        blocked = torch.zeros(r, dtype=torch.int32, device=dev).index_add_(
            0, s_rec, (pend & (first[gid] != s_rec)).to(torch.int32))
        sel = (pending & (blocked == 0)).nonzero().squeeze(1)
        n_left -= sel.shape[0]
        pending[sel] = False
        yield sel


class _LastWriter(NamedTuple):
    """Entries grouped by slot: ``slot`` sorted, ``src`` per sorted entry the
    last entry of its slot that writes (-1: none does)."""
    slot: torch.Tensor
    src: torch.Tensor


def _last_writer(idx: torch.Tensor, write: torch.Tensor) -> _LastWriter:
    s_idx, perm = torch.sort(idx)
    new = torch.ones_like(s_idx, dtype=torch.bool)
    new[1:] = s_idx[1:] != s_idx[:-1]
    gid = torch.cumsum(new, 0) - 1
    pos = torch.where(write[perm], perm, -1)
    last = torch.full_like(perm, -1).scatter_reduce_(0, gid, pos, "amax")
    return _LastWriter(s_idx, last[gid])


def _put(leaf: torch.Tensor, lw: _LastWriter, rows: torch.Tensor) -> None:
    """``leaf[slot] = rows[last writer]`` in place, and the slots only
    non-writing entries name keep their rows.  Every entry of a slot carries
    the same row, so one indexed write needs no compaction (no host wait)."""
    take = (lw.src >= 0).view(-1, *[1] * (leaf.dim() - 1))
    vals = torch.where(take, rows[lw.src.clamp_min(0)], leaf[lw.slot])
    leaf[lw.slot] = vals


def promote_pass(hot: ft.TrackerState, cold: ColdState, packets: ft.PacketBatch,
                 keep: Optional[torch.Tensor] = None, *, policy: str, lanes: int = 1
                 ) -> tuple[ft.TrackerState, ColdState, torch.Tensor]:
    """Step 1 of the two-level step, in place on ``hot`` and ``cold``: each
    segment head (ascending hot slot) whose tuple is not live in hot but is
    in cold loads the cold entry into its hot slot, frees the cold source
    and first spills a displaced hot occupant into cold.  Returns ``(hot,
    cold, promoted)``.

    The ordered walk carries only the small leaves (tuple_id, count,
    last_ts, stamp); the wide ones move after it, which is exact: heads own
    distinct hot slots, a promoted source still holds its pre-pass entry
    (an occupant inserted in this pass hashes to another head's hot slot,
    so it is never a later head's tuple), and where two occupants land on
    one cold slot the later one wins.  Under ``lru`` the walk stamps an
    occupant with ``tick0 + its head's index``, which orders like the true
    tick (all above the bank's older stamps), and the true ticks are written
    after the walk.  In a lane bank a head's lane is its hot slot's, and its
    clock that lane's tick."""
    _check_policy(policy)
    F, C, P = hot.tuple_id.shape[0], cold.tuple_id.shape[0], packets.ts.shape[0]
    dev = hot.count.device
    slots = ft.lane_slot(packets.tuple_hash, F, lanes)
    if keep is not None:
        slots = torch.where(keep, slots, F)
    s_slot, order = torch.sort(slots, stable=True)
    s_hash = packets.tuple_hash[order]
    first = torch.ones(P, dtype=torch.bool, device=dev)
    first[1:] = s_slot[1:] != s_slot[:-1]
    fs = torch.where(s_slot < F, s_slot, 0).long()
    lane = ft.lane_of(fs, F // lanes)
    live = hot.count[fs] > 0
    hit = live & (hot.tuple_id[fs] == s_hash)
    cand = first & (s_slot < F) & ~hit
    a, b = (x.long() for x in cold_slots(s_hash, C, lanes, lane))
    o_tid, o_cnt, o_ts = hot.tuple_id[fs], hot.count[fs], hot.last_ts[fs]
    oa, ob = (x.long() for x in cold_slots(o_tid, C, lanes, lane))
    touch = torch.stack([a, b, torch.where(live, oa, a), torch.where(live, ob, a)], dim=1)
    tick0 = cold.tick.clone()
    o_stamp = o_ts if policy == "age" else (
        tick0.reshape(-1)[lane] + torch.arange(P, device=dev)).to(torch.int32)

    promo_all = torch.zeros(P, dtype=torch.bool, device=dev)
    src_all = torch.zeros(P, dtype=torch.int64, device=dev)
    dst_all = torch.full((P,), -1, dtype=torch.int64, device=dev)
    loaded = {name: torch.zeros(P, dtype=torch.int32, device=dev)
              for name in ("tuple_id", "count", "last_ts")}
    for sel in _rounds(touch, cand):
        h, sa, sb = s_hash[sel], a[sel], b[sel]
        in_a = (cold.count[sa] > 0) & (cold.tuple_id[sa] == h)
        in_b = (cold.count[sb] > 0) & (cold.tuple_id[sb] == h)
        promo = in_a | in_b
        src = torch.where(in_a, sa, sb)  # a slot of this record alone in the round
        disp = promo & live[sel]
        # the occupant's 2-choice insert sees the source as freed
        soa, sob, ot = oa[sel], ob[sel], o_tid[sel]
        csrc = torch.where(promo, src, -1)
        occ_a = (cold.count[soa] > 0) & (soa != csrc)
        occ_b = (cold.count[sob] > 0) & (sob != csrc)
        match_a = occ_a & (cold.tuple_id[soa] == ot)
        match_b = occ_b & (cold.tuple_id[sob] == ot)
        victim = torch.where(cold.stamp[soa] <= cold.stamp[sob], soa, sob)
        choose = torch.where(match_a, soa, torch.where(match_b, sob, torch.where(
            ~occ_a, soa, torch.where(~occ_b, sob, victim))))
        promo_all[sel], src_all[sel] = promo, src
        dst_all[sel] = torch.where(disp, choose, -1)
        for name, leaf in loaded.items():
            leaf[sel] = getattr(cold, name)[src]
        # free the source, then insert the occupant (a record that does
        # neither rewrites its own slot with what it holds)
        for leaf in (cold.tuple_id, cold.count, cold.stamp):
            leaf[src] = torch.where(promo, 0, leaf[src])
        dst = torch.where(disp, choose, src)
        for leaf, val in ((cold.tuple_id, ot), (cold.count, o_cnt[sel]),
                          (cold.last_ts, o_ts[sel]), (cold.stamp, o_stamp[sel])):
            leaf[dst] = torch.where(disp, val, leaf[dst])

    disp_all = dst_all >= 0
    src_safe = torch.where(promo_all, src_all, 0)
    load_rows = {name: getattr(cold, name)[src_safe] for name in _WIDE}
    occ_rows = {name: getattr(hot, name)[fs] for name in _WIDE}  # before hot is written
    to_hot = _last_writer(fs, promo_all)
    for name in ("tuple_id", "count", "last_ts"):
        _put(getattr(hot, name), to_hot, loaded[name])
    for name in _WIDE:
        _put(getattr(hot, name), to_hot, load_rows[name])
    to_cold = _last_writer(torch.where(disp_all, dst_all, 0), disp_all)
    for name in _WIDE:
        _put(getattr(cold, name), to_cold, occ_rows[name])
    if policy == "lru":
        _put(cold.stamp, to_cold, _lane_stamps(tick0, lane, disp_all, lanes))
    _advance(cold, lane, disp_all, lanes)
    return hot, cold, promo_all.sum().to(torch.int32)


def apply_spills(cold: ColdState, spills: ft.SpillRecords, *, policy: str, lanes: int = 1
                 ) -> tuple[ColdState, torch.Tensor]:
    """Step 3, in place on ``cold``: insert the merge's eviction records in
    packet order (a later spill may evict an earlier one).  A record's stamp
    is known up front (``last_ts``, or under ``lru`` its lane's tick plus the
    records of its lane before it), so only records sharing a candidate slot
    wait for one another.  Returns ``(cold, inserted)``."""
    _check_policy(policy)
    C = cold.tuple_id.shape[0]
    m = spills.mask
    lane = ft.shard_of(spills.tuple_id, lanes)
    a, b = (x.long() for x in cold_slots(spills.tuple_id, C, lanes, lane))
    inserted = m.sum().to(torch.int32)
    stamp = spills.last_ts if policy == "age" else _lane_stamps(cold.tick, lane, m, lanes)
    for sel in _rounds(torch.stack([a, b], dim=1), m):
        _insert_one(cold, spills, sel, stamp[sel], a[sel], b[sel])
    _advance(cold, lane, m, lanes)
    return cold, inserted


def _insert_one(cold: ColdState, spills: ft.SpillRecords, sel: torch.Tensor,
                stamp: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> None:
    """The 2-choice insert of one record, for each record ``sel`` names at
    once (candidates ``a``/``b``), in place on ``cold``: their candidate slots
    are pairwise disjoint (one round of :func:`_rounds`), so no insert sees
    another's write."""
    h = spills.tuple_id[sel]
    tgt = _choose_slot(cold, h, a, b)
    for name in ("tuple_id", "count", "last_ts") + _WIDE:
        getattr(cold, name)[tgt] = getattr(spills, name)[sel]
    cold.stamp[tgt] = stamp


def scrub_live(cold: ColdState, hot: ft.TrackerState, packets: ft.PacketBatch,
               keep: Optional[torch.Tensor] = None, *, lanes: int = 1) -> ColdState:
    """Step 4, in place on ``cold``: clear every cold entry whose tuple is
    live in hot after the merge.  Only batch tuples can have established,
    so one (P,)-wide check covers every case; the clears carry one value a
    slot, so no order is needed and the host never waits."""
    F, C = hot.tuple_id.shape[0], cold.tuple_id.shape[0]
    h = packets.tuple_hash
    fs = ft.lane_slot(h, F, lanes).long()
    live = (hot.count[fs] > 0) & (hot.tuple_id[fs] == h)
    if keep is not None:
        live = live & keep
    a, b = (x.long() for x in cold_slots(h, C, lanes))
    idx = torch.cat([a, b])
    hits = torch.cat([live & (cold.count[a] > 0) & (cold.tuple_id[a] == h),
                      live & (cold.count[b] > 0) & (cold.tuple_id[b] == h)])
    clear = _last_writer(idx, hits)
    zeros = torch.zeros(idx.shape[0], dtype=torch.int32, device=idx.device)
    for leaf in (cold.tuple_id, cold.count, cold.stamp):
        _put(leaf, clear, zeros)
    return cold


def cold_occupancy(cold: ColdState) -> torch.Tensor:
    """() int32 — live cold entries."""
    return (cold.count > 0).sum().to(torch.int32)
