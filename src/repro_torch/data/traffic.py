"""Streaming synthetic traffic for the serving pipeline.

A live link: a fixed population of concurrent flows with a heavy-tailed
split — short *mice* flows that usually die below the tracker's top-n
threshold and long *elephants* that cross it — plus optional bursts of
back-to-back packets.  Completed flows are replaced by fresh ones, so the
stream never drains.  ``TrafficConfig.adversarial`` shapes it as an attack
(a flash crowd, an elephant storm, a hash-collision attack), and
:func:`merge_streams` interleaves several clients' generators.

The generator draws from the same numpy RNG in the same order as the JAX
package's ``TrafficGenerator``, so a seed gives the same packets there and
here; batches come out as :class:`PacketBatch` tensors on a chosen device.
The clock is int32 microseconds (the tracker's ts width); a run that would
overflow it raises instead of wrapping.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.common.util import Device, resolve_device
from repro_torch.core.flow_tracker import PacketBatch, hash_slot_scalar, shard_of

_TS_MAX = 2**31 - 1  # PacketBatch.ts is int32 microseconds


# ---------------------------------------------------------------------------
# Hash partitioning (multi-lane serving)
# ---------------------------------------------------------------------------

class ShardedBatch(NamedTuple):
    """One dispatch round of a hash-partitioned microbatch (S = num_shards
    lanes of capacity C).  Rows with ``keep == False`` are padding (zeroed
    packets, ``src == P``)."""

    shards: PacketBatch  # (S, C) leaves — per-lane packets, arrival order
    keep: torch.Tensor  # (S, C) bool — row holds a real packet
    src: torch.Tensor  # (S, C) int32 — original batch index (P for padding)


def lane_rounds(tuple_hash: np.ndarray, num_shards: int, *, lane_batch: Optional[int] = None,
                keep: Optional[np.ndarray] = None) -> tuple[np.ndarray, np.ndarray, int]:
    """The partition of :func:`partition_batch` as two (P,) int arrays on the
    host: each packet's lane (``shard_of``) and its round (the window of
    ``lane_batch`` packets of its lane's FIFO it falls in; -1 for a row
    ``keep`` drops), and the number of rounds (at least 1)."""
    n = tuple_hash.shape[0]
    if num_shards <= 0:
        raise ValueError(f"num_shards must be positive, got {num_shards}")
    cap = n if lane_batch is None else int(lane_batch)
    if not 0 < cap <= n:
        raise ValueError(f"lane_batch must be in [1, {n}], got {cap}")
    lane = shard_of(tuple_hash, num_shards)
    mask = np.ones(n, bool)
    if keep is not None:
        mask = np.asarray(keep, bool)
        if mask.shape != (n,):
            raise ValueError(f"keep must have shape ({n},), got {mask.shape}")
    rank = np.full(n, -1, np.int64)
    for s in range(num_shards):
        ix = np.flatnonzero((lane == s) & mask)
        rank[ix] = np.arange(ix.shape[0])
    rnd = np.where(mask, rank // cap, -1)
    return lane, rnd, max(1, int(rnd.max(initial=-1)) + 1)


def partition_batch(batch: PacketBatch, num_shards: int, *,
                    lane_batch: Optional[int] = None,
                    keep: Optional[np.ndarray] = None) -> list[ShardedBatch]:
    """Hash-partition one microbatch into ``num_shards`` lanes
    (``shard_of(tuple_hash)``), preserving per-lane arrival order.

    Every kept packet appears in exactly one lane of exactly one round with
    its keep bit set, at the lane ``shard_of`` names; padding rows are
    zeroed with ``src == P``.  ``lane_batch`` is the per-lane capacity C
    (default: the batch size, always one round); a lane that overfills
    spills into further rounds, its FIFO split into C-sized windows.
    ``keep`` pre-drops rows: they land in no lane of no round.  The leaves
    come back on the batch's device."""
    n = int(batch.ts.shape[0])
    hashes = batch.tuple_hash.cpu().numpy()
    lane, rnd, rounds = lane_rounds(hashes, num_shards, lane_batch=lane_batch, keep=keep)
    cap = n if lane_batch is None else int(lane_batch)
    dev = batch.ts.device
    out = []
    for r in range(rounds):
        keep_rows = np.zeros((num_shards, cap), bool)
        src = np.full((num_shards, cap), n, np.int64)
        for s in range(num_shards):
            window = np.flatnonzero((lane == s) & (rnd == r))
            keep_rows[s, :window.shape[0]] = True
            src[s, :window.shape[0]] = window
        kr = torch.from_numpy(keep_rows).to(dev)
        take = torch.from_numpy(np.minimum(src, n - 1)).to(dev)

        def gather(a: torch.Tensor) -> torch.Tensor:
            g = a[take]
            return torch.where(kr.view(*kr.shape, *[1] * (g.dim() - 2)), g, 0)

        out.append(ShardedBatch(shards=PacketBatch(*(gather(a) for a in batch)), keep=kr,
                                src=torch.from_numpy(src.astype(np.int32)).to(dev)))
    return out

ADVERSARIAL_MODES = ("none", "flash_crowd", "elephant_storm", "collision_attack")


@dataclass(frozen=True)
class TrafficConfig:
    batch_size: int = 32  # packets per emitted microbatch
    active_flows: int = 64  # concurrent flow population
    elephant_fraction: float = 0.125
    mice_pkts: tuple[int, int] = (2, 12)  # uniform packet-count range
    elephant_pkts: tuple[int, int] = (40, 120)
    burst_prob: float = 0.1  # chance a scheduled flow emits a burst
    burst_len: int = 4
    malicious_fraction: float = 0.2
    num_classes: int = 8
    pay_bytes: int = 16
    table_size: int = 1024
    collision_free: bool = True  # no two *live* flows share a table slot
    seed: int = 0
    client_id: int = 0  # stamped on the generator for multi-stream serving
    # adversarial modes, deterministic in `seed` like everything else:
    # "flash_crowd"       every adv_period-th batch is a crowd of batch_size
    #                     fresh one-packet flows (SYN-flood shape: maximal
    #                     flow-establishment churn, nothing ever goes ready)
    # "elephant_storm"    every spawned flow is an elephant and every
    #                     scheduled emission a maximal burst_len burst
    #                     (line-rate pressure on the ready/drain path)
    # "collision_attack"  every spawned flow hashes into one of the first
    #                     adv_slots tracker slots (worst-case eviction churn,
    #                     and the segmented tracker's in-batch collision
    #                     fallback on every batch); with adv_shards > 0 the
    #                     flows also all land in shard 0 of an adv_shards-lane
    #                     partition, so same-slot flows share a shard while
    #                     lane 0 takes the whole attack
    adversarial: str = "none"
    adv_period: int = 4  # flash_crowd: a crowd every adv_period-th batch
    adv_slots: int = 2  # collision_attack: number of targeted hot slots
    adv_shards: int = 0  # collision_attack: pin flows to shard 0 of N lanes

    def __post_init__(self):
        if self.adversarial not in ADVERSARIAL_MODES:
            raise ValueError(f"adversarial must be one of {ADVERSARIAL_MODES}, "
                             f"got {self.adversarial!r}")
        if self.adv_period <= 0:
            raise ValueError(f"adv_period must be positive, got {self.adv_period}")
        if not 0 < self.adv_slots <= self.table_size:
            raise ValueError(f"adv_slots must be in [1, table_size="
                             f"{self.table_size}], got {self.adv_slots}")
        if self.adv_shards < 0:
            raise ValueError(f"adv_shards must be >= 0, got {self.adv_shards}")
        if self.adversarial == "collision_attack" and self.collision_free:
            raise ValueError("collision_attack concentrates live flows onto "
                             "shared slots — set collision_free=False")


class _Flow:
    __slots__ = ("tuple_hash", "slot", "cls", "malicious", "elephant",
                 "remaining", "mu_size", "mu_intv", "proto", "last_dir")

    def __init__(self, tuple_hash: int, slot: int, cls: int, malicious: bool,
                 elephant: bool, remaining: int, mu_size: float,
                 mu_intv: float, proto: int):
        self.tuple_hash = tuple_hash
        self.slot = slot
        self.cls = cls
        self.malicious = malicious
        self.elephant = elephant
        self.remaining = remaining
        self.mu_size = mu_size
        self.mu_intv = mu_intv
        self.proto = proto
        self.last_dir = 0


class TrafficGenerator:
    """Seeded infinite stream of fixed-size packet microbatches on ``device``
    (the card unless another is named).

    Iterating yields :class:`PacketBatch` forever — bound it with
    ``OctopusPipeline.run(traffic, steps=N)`` or ``batches(steps)``."""

    def __init__(self, cfg: TrafficConfig = TrafficConfig(), *, device: Device = None):
        if cfg.batch_size <= 0 or cfg.active_flows <= 0:
            raise ValueError("batch_size and active_flows must be positive")
        if cfg.collision_free and cfg.active_flows > cfg.table_size:
            raise ValueError("collision_free needs active_flows <= table_size")
        if (cfg.adversarial == "flash_crowd" and cfg.collision_free
                and cfg.active_flows + cfg.batch_size > cfg.table_size):
            raise ValueError(
                "flash_crowd spawns batch_size extra live flows per crowd "
                "batch — collision_free needs active_flows + batch_size <= "
                "table_size")
        self.cfg = cfg
        self.client_id = cfg.client_id
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(cfg.seed)
        self.clock = 0  # global microsecond clock (ts are non-decreasing)
        self.flows_started = 0
        self.flows_completed = 0
        self.batches_emitted = 0
        self._live_slots: set[int] = set()
        self._live_hashes: set[int] = set()
        self._flows = [self._spawn_flow() for _ in range(cfg.active_flows)]

    def _spawn_flow(self) -> _Flow:
        c = self.cfg
        attack = c.adversarial == "collision_attack"
        tries = 64 * max(c.table_size, 1) * (max(1, c.adv_shards) if attack else 1)
        for _ in range(tries):
            h = int(self.rng.integers(1, 2**31 - 1))
            slot = hash_slot_scalar(h, c.table_size)
            if attack and (slot >= c.adv_slots
                           or (c.adv_shards and shard_of(h, c.adv_shards) != 0)):
                continue
            # live tuple hashes are unique in every mode; slot uniqueness is
            # the extra constraint of collision_free
            if h not in self._live_hashes and (
                    not c.collision_free or slot not in self._live_slots):
                break
        else:  # pragma: no cover - astronomically unlikely under the guard
            raise RuntimeError("could not find a collision-free slot")
        self._live_slots.add(slot)
        self._live_hashes.add(h)

        # no draw under elephant_storm: every flow is an elephant
        elephant = (True if c.adversarial == "elephant_storm"
                    else self.rng.random() < c.elephant_fraction)
        lo, hi = c.elephant_pkts if elephant else c.mice_pkts
        cls = int(self.rng.integers(0, c.num_classes))
        malicious = self.rng.random() < c.malicious_fraction
        mu_size, mu_intv = 200 + 80 * cls, 50.0 * (cls + 1)
        if malicious:  # small fast packets
            cls, mu_size, mu_intv = 0, 64, 5.0
        self.flows_started += 1
        return _Flow(h, slot, cls, malicious, elephant,
                     int(self.rng.integers(lo, hi + 1)), mu_size, mu_intv,
                     int(self.rng.integers(0, 3)))

    def _retire(self, idx: int) -> None:
        f = self._flows[idx]
        self._live_slots.discard(f.slot)
        self._live_hashes.discard(f.tuple_hash)
        self.flows_completed += 1
        self._flows[idx] = self._spawn_flow()

    def _tick(self, mu: float) -> int:
        """Advance the clock by one ~exp(mu) inter-arrival, failing before the
        int32 wrap (negative inter-arrival times would corrupt the tracker)."""
        self.clock += max(1, int(self.rng.exponential(mu)))
        if self.clock > _TS_MAX:
            raise RuntimeError(f"traffic clock exceeded int32 microseconds ({_TS_MAX}); "
                               "restart the generator for longer runs")
        return self.clock

    def _emit(self, ts, size, dirs, flags, proto, thash, payload) -> PacketBatch:
        to = lambda a: torch.from_numpy(a).to(self.device)
        return PacketBatch(ts=to(ts), size=to(size), dir=to(dirs), flags=to(flags),
                           proto=to(proto), tuple_hash=to(thash), payload=to(payload))

    def _crowd_batch(self) -> PacketBatch:
        """One flash-crowd microbatch: ``batch_size`` fresh one-packet flows
        (unique live hashes, like every spawn), each retired at once; the
        draws a packet go spawn, tick, size, payload."""
        c = self.cfg
        n = c.batch_size
        ts, size, dirs, flags, proto, thash = (np.zeros(n, np.int32) for _ in range(6))
        payload = np.zeros((n, c.pay_bytes), np.int32)
        for i in range(n):
            f = self._spawn_flow()
            ts[i] = self._tick(2.0)  # near-line-rate arrival spacing
            size[i] = int(np.clip(self.rng.normal(64, 8), 40, 1500))
            flags[i] = 2  # SYN-like
            proto[i] = f.proto
            thash[i] = f.tuple_hash
            payload[i] = self.rng.integers(0, 256, c.pay_bytes)
            # one packet and gone: release the live slot and hash without
            # touching the steady population in self._flows
            self._live_slots.discard(f.slot)
            self._live_hashes.discard(f.tuple_hash)
            self.flows_completed += 1
        return self._emit(ts, size, dirs, flags, proto, thash, payload)

    def next_batch(self) -> PacketBatch:
        c = self.cfg
        self.batches_emitted += 1
        if c.adversarial == "flash_crowd" and self.batches_emitted % c.adv_period == 0:
            return self._crowd_batch()
        n = c.batch_size
        ts, size, dirs, flags, proto, thash = (np.zeros(n, np.int32) for _ in range(6))
        payload = np.zeros((n, c.pay_bytes), np.int32)

        i = 0
        while i < n:
            idx = int(self.rng.integers(0, len(self._flows)))
            f = self._flows[idx]
            if c.adversarial == "elephant_storm":
                burst = c.burst_len  # every emission a maximal burst, no draws
            else:
                burst = 1
                if self.rng.random() < c.burst_prob:
                    burst = int(self.rng.integers(2, c.burst_len + 1))
            for _ in range(min(burst, f.remaining, n - i)):
                ts[i] = self._tick(f.mu_intv)
                size[i] = int(np.clip(self.rng.normal(f.mu_size, 40), 40, 1500))
                f.last_dir ^= int(self.rng.random() < 0.4)  # occasional turn
                dirs[i] = f.last_dir
                flags[i] = int(self.rng.integers(0, 64))
                proto[i] = f.proto
                thash[i] = f.tuple_hash
                row = self.rng.integers(0, 256, c.pay_bytes)
                row[0] = (f.cls * 13 + 7) % 256  # class signature byte
                if f.malicious:
                    row[1] = 251
                payload[i] = row
                f.remaining -= 1
                i += 1
            if f.remaining == 0:
                self._retire(idx)

        return self._emit(ts, size, dirs, flags, proto, thash, payload)

    def batches(self, steps: Optional[int] = None) -> Iterator[PacketBatch]:
        """Yield ``steps`` microbatches (forever when ``steps`` is None)."""
        produced = 0
        while steps is None or produced < steps:
            yield self.next_batch()
            produced += 1

    def __iter__(self) -> Iterator[PacketBatch]:
        return self.batches(None)


def merge_streams(*gens: TrafficGenerator, seed: int = 0, steps: Optional[int] = None,
                  tagged: bool = False) -> Iterator:
    """Interleave N seeded generators into one stream, deterministically.

    Each microbatch is pulled whole from one generator, chosen by an RNG of
    its own keyed by ``seed``, so the same seed and generator configs give
    the same stream, batch for batch.  Every batch a generator produces
    appears once, in that generator's own order: the merge reorders across
    clients, never within one.  ``tagged=True`` yields ``(client_id,
    PacketBatch)`` pairs, the default bare batches (which can drive
    ``OctopusPipeline.run``); ``steps`` bounds the count (the generators
    never end)."""
    if not gens:
        raise ValueError("merge_streams needs at least one generator")
    rng = np.random.default_rng(seed)
    produced = 0
    while steps is None or produced < steps:
        g = gens[int(rng.integers(0, len(gens)))]
        batch = g.next_batch()
        yield (g.client_id, batch) if tagged else batch
        produced += 1


def prefetch(iterable, depth: int = 2) -> Iterator:
    """Pull ``iterable`` on a background thread, staying up to ``depth``
    items ahead of the consumer (a bounded queue: the producer blocks when
    the consumer falls behind, so memory stays O(depth)).

    The consumer sees exactly the source sequence, so a prefetched pipeline
    run gives the same results; a producer error is raised again at the
    consumer's next pull.  Use it with the overlapped pipeline to move batch
    generation off the dispatch thread::

        pipe.run(prefetch(gen.batches(steps), depth=2), steps=steps)

    The producer runs ahead by up to ``depth`` items, so wrap only bounded
    iterators you own.  The thread is a daemon and starts at the first
    ``next()``, so an unconsumed prefetch costs nothing and an abandoned one
    never blocks interpreter exit."""
    import queue
    import threading

    if depth <= 0:
        raise ValueError(f"depth must be positive, got {depth}")
    q: queue.Queue = queue.Queue(maxsize=depth)
    end = object()  # sentinel: (end, exception-or-None) closes the stream

    def produce() -> None:
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 — raised again in the consumer
            q.put((end, e))
            return
        q.put((end, None))

    threading.Thread(target=produce, name="traffic-prefetch", daemon=True).start()
    while True:
        item = q.get()
        if isinstance(item, tuple) and len(item) == 2 and item[0] is end:
            if item[1] is not None:
                raise item[1]
            return
        yield item
