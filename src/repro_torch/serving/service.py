"""Async batch serving frontend over the streaming pipelines.

Many clients submit packet microbatches of any size; one fixed-shape
pipeline serves them.  :class:`OctopusService` puts a queue in front of
:class:`~repro_torch.serving.pipeline.OctopusPipeline` (or the sharded
:class:`~repro_torch.serving.sharded.ShardedOctopusPipeline`; both expose the
``warm_bucket``/``step_masked`` masked entry):

  * a **request queue** of per-client microbatches (:meth:`OctopusService.submit`),
  * a **batcher** that coalesces queued requests in FIFO order and pads them
    to the smallest configured ``bucket`` that fits; every bucket's masked
    entry is warmed at :meth:`OctopusService.start`, so a ragged arrival
    never dispatches a size that was not run before (its kernels are built
    and the allocator has seen its shapes),
  * **staging buffers** pooled per bucket: pinned host tensors on the card
    (copied ``non_blocking``), reused, not allocated, per dispatch,
  * **admission control**: past ``depth_budget`` queued packets a new
    request gets a :class:`Rejected` result (``"shed"``) or waits for space
    (``"block"``),
  * **latency observability**: per-client and global p50/p99 queue wait and
    end to end (:class:`~repro_torch.serving.pipeline.LatencyReservoir`, µs)
    and the queue's high-water mark in :class:`ServiceStats`.

Dispatches are serialised (the tracker state is one sequential carry).  With
``ServiceConfig.offload`` (the default) the pack and the masked step run on
a one-thread executor, so the event loop keeps accepting submits while a
step runs and the next dispatch coalesces what arrived meanwhile.  A failing
dispatch answers every coalesced request with the error, returns the
staging buffer to the pool and restores the queue depth, so admission never
wedges.

A request of ``b < bucket`` packets served padded gives the verdicts and the
tracker state of the unpadded pipeline step, bit for bit (the keep mask).
"""
from __future__ import annotations

import asyncio
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core.flow_tracker import PacketBatch
from repro_torch.data.traffic import TrafficGenerator
from repro_torch.serving.pipeline import LatencyReservoir, OctopusPipeline

ADMISSION_POLICIES = ("shed", "block")

_FIELDS = PacketBatch._fields  # every leaf int32: six (n,), payload (n, pay_bytes)


@dataclass(frozen=True)
class ServiceConfig:
    """Knobs of the serving frontend."""

    buckets: tuple[int, ...] = (32, 64, 128, 256)  # warmed batch shapes
    depth_budget: int = 1024  # max queued packets before admission control
    admission: str = "shed"  # "shed" -> Rejected result | "block" -> await
    batch_wait_s: float = 0.0  # grace the batcher waits to coalesce more
    sample_capacity: int = 1024  # latency reservoir depth (per scope)
    pool_depth: int = 4  # staging buffers retained per bucket
    offload: bool = True  # pack + dispatch on an executor thread; False: inline

    def __post_init__(self):
        if not self.buckets or any(b <= 0 for b in self.buckets):
            raise ValueError(f"buckets must be positive, got {self.buckets}")
        if tuple(sorted(set(self.buckets))) != tuple(self.buckets):
            raise ValueError(f"buckets must be strictly increasing, got {self.buckets}")
        if self.admission not in ADMISSION_POLICIES:
            raise ValueError(f"admission must be one of {ADMISSION_POLICIES}, "
                             f"got {self.admission!r}")
        if self.depth_budget <= 0 or self.pool_depth <= 0:
            raise ValueError("depth_budget and pool_depth must be positive")
        if self.batch_wait_s < 0:
            raise ValueError(f"batch_wait_s must be >= 0, got {self.batch_wait_s}")


@dataclass(frozen=True)
class ServeResult:
    """One served request: per-packet verdicts in the request's own order."""

    client_id: int
    pkt_actions: np.ndarray  # (n,) int32 packet-head verdicts
    bucket: int  # largest bucket a chunk of this request dispatched in (0: empty submit)
    queue_wait_s: float  # enqueue -> dispatch start
    e2e_s: float  # enqueue -> verdicts ready
    buckets: tuple[int, ...] = ()  # each chunk's dispatch bucket, in order


@dataclass(frozen=True)
class Rejected:
    """Admission-control shed: the queue was over budget when this request
    arrived.  A result, not an exception: the client retries or backs off."""

    client_id: int
    packets: int  # size of the rejected request
    queue_depth: int  # queued packets at rejection time
    depth_budget: int


SubmitOutcome = Union[ServeResult, Rejected]


@dataclass
class ClientStats:
    """Per-client slice of the service counters."""

    requests: int = 0
    submitted: int = 0  # packets offered (incl. shed)
    served: int = 0  # packets that got verdicts
    shed: int = 0  # packets rejected by admission control
    wait: LatencyReservoir = field(default_factory=LatencyReservoir)
    e2e: LatencyReservoir = field(default_factory=LatencyReservoir)


@dataclass
class ServiceStats:
    """Global service counters and the per-client breakdown.  The latency
    reservoirs hold microseconds; idle percentiles are ``nan``."""

    requests: int = 0
    served_requests: int = 0
    shed_requests: int = 0
    submitted: int = 0  # packets offered
    served: int = 0  # packets dispatched and answered
    shed: int = 0  # packets rejected
    dispatches: int = 0  # bucket dispatches issued
    coalesced: int = 0  # requests merged into those dispatches
    padded: int = 0  # bucket pad rows dispatched (masked)
    depth_hwm: int = 0  # queue-depth high-water mark (packets)
    pool_hits: int = 0
    pool_misses: int = 0
    failed_dispatches: int = 0  # dispatches whose step raised
    failed: int = 0  # packets answered with an error instead of verdicts
    host_s: float = 0.0  # dispatch host share: staging pack, verdict read
    device_s: float = 0.0  # dispatch share inside the masked step
    started_at: float = 0.0  # perf_counter at start(); 0 = never started
    stopped_at: float = 0.0  # perf_counter at stop(); 0 while running
    wait: LatencyReservoir = field(default_factory=LatencyReservoir)
    e2e: LatencyReservoir = field(default_factory=LatencyReservoir)
    clients: dict[int, ClientStats] = field(default_factory=dict)

    def client(self, client_id: int) -> ClientStats:
        st = self.clients.get(client_id)
        if st is None:
            cap = self.wait.capacity
            st = self.clients[client_id] = ClientStats(
                wait=LatencyReservoir(cap), e2e=LatencyReservoir(cap))
        return st

    @property
    def wall_s(self) -> float:
        """Service wall clock, read at the time of the read while the service
        runs and frozen at :meth:`OctopusService.stop`."""
        if not self.started_at:
            return 0.0
        end = self.stopped_at if self.stopped_at else time.perf_counter()
        return max(end - self.started_at, 0.0)

    @property
    def pkt_per_s(self) -> float:
        """Served packets over the service's wall clock."""
        wall = self.wall_s
        return self.served / wall if wall > 0 else 0.0

    @property
    def host_us(self) -> float:
        """Mean host share per dispatch."""
        return self.host_s / self.dispatches * 1e6 if self.dispatches else float("nan")

    @property
    def device_us(self) -> float:
        """Mean masked-step share per dispatch."""
        return self.device_s / self.dispatches * 1e6 if self.dispatches else float("nan")


class _BufferPool:
    """Per-bucket pool of host staging tensors: one PacketBatch worth of
    leaves and a keep mask, pinned when the pipeline runs on the card.  A
    buffer is released only after the masked step returns, and that step
    waits for its read-back, which the card runs after the batch's copy, so
    a released buffer is safe to refill."""

    def __init__(self, pay_bytes: int, depth: int, stats: ServiceStats, pin: bool):
        self.pay_bytes = pay_bytes
        self.depth = depth
        self.stats = stats
        self.pin = pin
        self._free: dict[int, list[dict]] = {}

    def acquire(self, bucket: int) -> dict:
        free = self._free.setdefault(bucket, [])
        if free:
            self.stats.pool_hits += 1
            return free.pop()
        self.stats.pool_misses += 1
        zeros = lambda *shape, dtype=torch.int32: torch.zeros(shape, dtype=dtype,
                                                               pin_memory=self.pin)
        buf = {f: zeros(bucket) for f in _FIELDS[:-1]}
        buf["payload"] = zeros(bucket, self.pay_bytes)
        buf["keep"] = zeros(bucket, dtype=torch.bool)
        return buf

    def release(self, buf: dict) -> None:
        free = self._free.setdefault(buf["keep"].shape[0], [])
        if len(free) < self.depth:
            free.append(buf)


@dataclass
class _Pending:
    """One queued request chunk (a submit past the largest bucket splits into
    several, each at most one bucket)."""

    client_id: int
    leaves: dict  # the request's CPU tensors, leaf by leaf
    n: int
    enqueued_at: float
    future: asyncio.Future
    dispatched_at: float = 0.0
    bucket: int = 0  # the bucket this chunk dispatched in


class OctopusService:
    """Asyncio serving frontend over an :class:`OctopusPipeline` or a
    :class:`~repro_torch.serving.sharded.ShardedOctopusPipeline`.

    Lifecycle::

        service = OctopusService(pipeline, ServiceConfig(buckets=(32, 64)))
        await service.start()        # warms every bucket's masked entry
        result = await service.submit(batch, client_id=7)
        await service.stop()         # drains the queue, then stops

    or ``async with OctopusService(...) as service: ...``.
    """

    def __init__(self, pipeline: OctopusPipeline, cfg: ServiceConfig = ServiceConfig()):
        self.pipeline = pipeline
        self.cfg = cfg
        self.stats = ServiceStats(wait=LatencyReservoir(cfg.sample_capacity),
                                  e2e=LatencyReservoir(cfg.sample_capacity))
        self._pool = _BufferPool(pipeline.cfg.pay_bytes, cfg.pool_depth, self.stats,
                                 pin=pipeline.device.type == "cuda")
        self._queue: deque[_Pending] = deque()
        self._depth = 0  # queued packets
        self._work: Optional[asyncio.Event] = None
        self._space: Optional[asyncio.Event] = None
        self._dispatcher: Optional[asyncio.Task] = None
        self._executor: Optional[ThreadPoolExecutor] = None
        self._stopping = False

    # ------------------------------------------------------------- lifecycle
    @property
    def queue_depth(self) -> int:
        """Currently queued packets (admission control's input)."""
        return self._depth

    async def start(self) -> None:
        """Warm every bucket's masked entry (outside any timed region) and
        start the dispatcher task, with its one-thread executor under
        ``cfg.offload``."""
        if self._dispatcher is not None:
            raise RuntimeError("service already started")
        for b in self.cfg.buckets:
            self.pipeline.warm_bucket(b)
        self._work = asyncio.Event()
        self._space = asyncio.Event()
        self._stopping = False
        if self.cfg.offload:
            # one worker: the tracker state is a sequential carry, so
            # dispatches serialise; the thread only keeps the loop free
            self._executor = ThreadPoolExecutor(max_workers=1,
                                                thread_name_prefix="octopus-dispatch")
        self.stats.started_at = time.perf_counter()
        self.stats.stopped_at = 0.0
        self._dispatcher = asyncio.create_task(self._dispatch_loop())

    async def stop(self) -> None:
        """Drain the queue (every accepted request still gets its result),
        then stop the dispatcher and freeze the wall clock."""
        if self._dispatcher is None:
            return
        self._stopping = True
        self._work.set()
        await self._dispatcher
        self._dispatcher = None
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None
        self.stats.stopped_at = time.perf_counter()

    async def __aenter__(self) -> "OctopusService":
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # ---------------------------------------------------------------- submit
    def _host_leaves(self, packets: PacketBatch) -> dict:
        leaves = {f: getattr(packets, f).cpu() for f in _FIELDS}
        if leaves["payload"].shape[1:] != (self.pipeline.cfg.pay_bytes,):
            raise ValueError(f"payload width {tuple(leaves['payload'].shape[1:])} does not "
                             f"match the pipeline's pay_bytes={self.pipeline.cfg.pay_bytes}")
        return leaves

    async def submit(self, packets: PacketBatch, client_id: int = 0) -> SubmitOutcome:
        """Queue one microbatch (any size) and await its verdicts.

        Admission runs before anything is enqueued, against the whole
        request: ``"shed"`` returns :class:`Rejected` at once when the queue
        is over budget, ``"block"`` waits for space.  A request past the
        largest bucket splits into bucket-sized chunks that dispatch in
        order (still one result)."""
        if self._dispatcher is None:
            raise RuntimeError("service not started (use `async with` or "
                               "`await service.start()`)")
        leaves = self._host_leaves(packets)
        n = int(leaves["ts"].shape[0])
        if n == 0:  # an empty submit answers at once and counts nothing
            return ServeResult(client_id, np.zeros(0, np.int32), 0, 0.0, 0.0)
        gstats = self.stats
        cstats = gstats.client(client_id)
        gstats.requests += 1
        cstats.requests += 1
        gstats.submitted += n
        cstats.submitted += n

        if self._depth + n > self.cfg.depth_budget:
            if self.cfg.admission == "shed":
                gstats.shed_requests += 1
                cstats.shed += n
                gstats.shed += n
                return Rejected(client_id, n, self._depth, self.cfg.depth_budget)
            while self._depth + n > self.cfg.depth_budget:
                self._space.clear()
                await self._space.wait()

        # every chunk enqueues before the first await, so admission order is
        # submission order (a gather of submits sheds deterministically)
        top = self.cfg.buckets[-1]
        loop = asyncio.get_running_loop()
        now = time.perf_counter()
        chunks = [_Pending(client_id, {k: v[off:off + top] for k, v in leaves.items()},
                           min(top, n - off), now, loop.create_future())
                  for off in range(0, n, top)]
        self._queue.extend(chunks)
        self._depth += n
        gstats.depth_hwm = max(gstats.depth_hwm, self._depth)
        self._work.set()

        # return_exceptions: every chunk's error is consumed here; one failed
        # dispatch fails the whole request (partial verdicts are unusable)
        results = await asyncio.gather(*(c.future for c in chunks), return_exceptions=True)
        errors = [r for r in results if isinstance(r, BaseException)]
        if errors:
            raise errors[0]
        done = time.perf_counter()
        actions = np.concatenate(results)
        wait_s = chunks[0].dispatched_at - now
        e2e_s = done - now
        gstats.served_requests += 1
        gstats.served += n
        cstats.served += n
        for st in (gstats, cstats):
            st.wait.add(wait_s * 1e6)
            st.e2e.add(e2e_s * 1e6)
        buckets = tuple(c.bucket for c in chunks)
        return ServeResult(client_id, actions, max(buckets), wait_s, e2e_s, buckets)

    # ------------------------------------------------------------- dispatcher
    def _bucket_for(self, n: int) -> int:
        for b in self.cfg.buckets:
            if n <= b:
                return b
        raise AssertionError(f"chunk of {n} exceeds the largest bucket "
                             f"{self.cfg.buckets[-1]}")  # pragma: no cover

    def _take_coalesced(self) -> list[_Pending]:
        """Pop a FIFO run of requests that fits the largest bucket (always at
        least one: chunks never exceed it)."""
        top = self.cfg.buckets[-1]
        reqs = [self._queue.popleft()]
        total = reqs[0].n
        while self._queue and total + self._queue[0].n <= top:
            nxt = self._queue.popleft()
            reqs.append(nxt)
            total += nxt.n
        return reqs

    def _dispatch_blocking(self, reqs: list[_Pending]
                           ) -> tuple[np.ndarray, dict, int, float, float]:
        """The blocking half of one dispatch: pack a coalesced run into a
        pooled staging buffer, pad it to the bucket, run the masked step and
        read the verdicts.  Runs on the executor under ``cfg.offload``
        (inline otherwise) and touches no asyncio state.  On a failing step
        the buffer goes back to the pool here; futures and queue depth are
        the loop side's.  Returns ``(actions, buf, bucket, host_s,
        device_s)``."""
        total = sum(r.n for r in reqs)
        bucket = self._bucket_for(total)
        t0 = time.perf_counter()
        buf = self._pool.acquire(bucket)
        try:
            off = 0
            for r in reqs:
                for f in _FIELDS:
                    buf[f][off:off + r.n] = r.leaves[f]
                off += r.n
            for f in _FIELDS:  # zero the pad tail: no stale rows
                buf[f][total:] = 0
            buf["keep"][:total] = True
            buf["keep"][total:] = False

            t_dispatch = time.perf_counter()
            for r in reqs:
                r.dispatched_at = t_dispatch
                r.bucket = bucket
            batch = PacketBatch(*(buf[f] for f in _FIELDS))
            t1 = time.perf_counter()
            out = self.pipeline.step_masked(batch, buf["keep"])
            t2 = time.perf_counter()
            actions = out.pkt_actions.cpu().numpy()
            host_s = (t1 - t0) + (time.perf_counter() - t2)
            return actions, buf, bucket, host_s, t2 - t1
        except BaseException:
            self._pool.release(buf)
            raise

    async def _dispatch_one(self, reqs: list[_Pending]) -> None:
        """One dispatch: the blocking half (off the loop under
        ``cfg.offload``), then every coalesced request answered with its
        slice of the verdicts, or with the error if the step raised.  Queue
        depth and the space event are restored either way."""
        total = sum(r.n for r in reqs)
        try:
            if self._executor is not None:
                actions, buf, bucket, host_s, device_s = \
                    await asyncio.get_running_loop().run_in_executor(
                        self._executor, self._dispatch_blocking, reqs)
            else:
                actions, buf, bucket, host_s, device_s = self._dispatch_blocking(reqs)
        except Exception as e:
            self.stats.failed_dispatches += 1
            self.stats.failed += total
            for r in reqs:
                if not r.future.done():
                    r.future.set_exception(e)
        else:
            off = 0
            for r in reqs:
                r.future.set_result(actions[off:off + r.n].copy())
                off += r.n
            self._pool.release(buf)
            self.stats.dispatches += 1
            self.stats.coalesced += len(reqs)
            self.stats.padded += bucket - total
            self.stats.host_s += host_s
            self.stats.device_s += device_s
        finally:
            self._depth -= total
            self._space.set()

    async def _dispatch_loop(self) -> None:
        while True:
            await self._work.wait()
            if not self._queue:
                if self._stopping:
                    return
                self._work.clear()
                continue
            if self.cfg.batch_wait_s > 0:
                # coalescing grace: concurrent clients land their submits
                # before the bucket is chosen
                await asyncio.sleep(self.cfg.batch_wait_s)
            else:
                # yield once so a gather of submits enqueues as one wave
                await asyncio.sleep(0)
            if not self._queue:
                continue
            await self._dispatch_one(self._take_coalesced())


async def serve_stream(service: OctopusService, gen: TrafficGenerator, *, requests: int,
                       client_id: Optional[int] = None) -> list[SubmitOutcome]:
    """Closed-loop client: submit ``requests`` microbatches from one seeded
    generator, each awaited before the next, and return the outcomes.  Run
    several under ``asyncio.gather`` for a multi-client load."""
    cid = gen.client_id if client_id is None else client_id
    results: list[SubmitOutcome] = []
    for batch in gen.batches(requests):
        results.append(await service.submit(batch, client_id=cid))
    return results


__all__ = ["OctopusService", "ServiceConfig", "ServiceStats", "ClientStats", "ServeResult",
           "Rejected", "ADMISSION_POLICIES", "serve_stream"]
