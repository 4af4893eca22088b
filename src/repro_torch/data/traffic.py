"""Streaming synthetic traffic for the serving pipeline.

A live link: a fixed population of concurrent flows with a heavy-tailed
split — short *mice* flows that usually die below the tracker's top-n
threshold and long *elephants* that cross it — plus optional bursts of
back-to-back packets.  Completed flows are replaced by fresh ones, so the
stream never drains.

The generator draws from the same numpy RNG in the same order as the JAX
package's ``TrafficGenerator``, so a seed gives the same packets there and
here; batches come out as :class:`PacketBatch` tensors on a chosen device.
The clock is int32 microseconds (the tracker's ts width); a run that would
overflow it raises instead of wrapping.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.common.util import Device, resolve_device
from repro_torch.core.flow_tracker import PacketBatch, hash_slot_scalar

_TS_MAX = 2**31 - 1  # PacketBatch.ts is int32 microseconds

# "flash_crowd" and "elephant_storm" are not ported yet
ADVERSARIAL_MODES = ("none", "collision_attack")


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
    # "collision_attack": every spawned flow hashes into one of the first
    # adv_slots tracker slots (worst-case eviction churn, and the segmented
    # tracker's in-batch collision fallback on every batch)
    adversarial: str = "none"
    adv_slots: int = 2

    def __post_init__(self):
        if self.adversarial not in ADVERSARIAL_MODES:
            raise ValueError(f"adversarial must be one of {ADVERSARIAL_MODES}, "
                             f"got {self.adversarial!r}")
        if not 0 < self.adv_slots <= self.table_size:
            raise ValueError(f"adv_slots must be in [1, table_size="
                             f"{self.table_size}], got {self.adv_slots}")
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
        self.cfg = cfg
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
        for _ in range(64 * max(c.table_size, 1)):
            h = int(self.rng.integers(1, 2**31 - 1))
            slot = hash_slot_scalar(h, c.table_size)
            if attack and slot >= c.adv_slots:
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

        elephant = self.rng.random() < c.elephant_fraction
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

    def next_batch(self) -> PacketBatch:
        c = self.cfg
        self.batches_emitted += 1
        n = c.batch_size
        ts, size, dirs, flags, proto, thash = (np.zeros(n, np.int32) for _ in range(6))
        payload = np.zeros((n, c.pay_bytes), np.int32)

        i = 0
        while i < n:
            idx = int(self.rng.integers(0, len(self._flows)))
            f = self._flows[idx]
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

        to = lambda a: torch.from_numpy(a).to(self.device)
        return PacketBatch(ts=to(ts), size=to(size), dir=to(dirs), flags=to(flags),
                           proto=to(proto), tuple_hash=to(thash), payload=to(payload))

    def batches(self, steps: Optional[int] = None) -> Iterator[PacketBatch]:
        """Yield ``steps`` microbatches (forever when ``steps`` is None)."""
        produced = 0
        while steps is None or produced < steps:
            yield self.next_batch()
            produced += 1

    def __iter__(self) -> Iterator[PacketBatch]:
        return self.batches(None)


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
