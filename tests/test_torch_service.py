"""The port's ``OctopusService`` against the JAX package's on the same
submits: per-request verdicts and dispatch buckets, shed results, the rule
table, and the service's and pipeline's counters (dispatches, coalesced,
padded, shed, pool hits and misses), over the single-lane and the sharded
pipeline, inline and offloaded dispatch, shed and block admission.  Then the
frontend's own contracts, as ``tests/test_service.py`` holds the
reference's: padded serving equals the unpadded step, every dispatch rides a
bucket warmed at start, the failure path resolves and unblocks, the wall
clock reads fresh, latency stats per client.

The JAX pipelines run without ``use_pallas``; traffic comes from each
package's own generator (the port's draws the reference's packets)."""
import asyncio
import math

import jax
import numpy as np
import pytest
import torch
from asyncio_compat import async_test

from repro.data.traffic import TrafficConfig as JTrafficConfig
from repro.data.traffic import TrafficGenerator as JTrafficGenerator
from repro.models import paper_models as jpm
from repro.runtime import RuntimeConfig as JRuntimeConfig
from repro.serving import OctopusPipeline as JOctopusPipeline
from repro.serving import OctopusService as JOctopusService
from repro.serving import PipelineConfig as JPipelineConfig
from repro.serving import Rejected as JRejected
from repro.serving import ServiceConfig as JServiceConfig
from repro.serving import ShardedOctopusPipeline as JShardedOctopusPipeline
from repro.serving import serve_stream as j_serve_stream
from repro_torch import convert
from repro_torch.core import flow_tracker as ft
from repro_torch.data.traffic import TrafficConfig, TrafficGenerator
from repro_torch.serving import (
    OctopusPipeline,
    OctopusService,
    PipelineConfig,
    Rejected,
    ServeResult,
    ServiceConfig,
    ShardedOctopusPipeline,
    serve_stream,
)

SHAPE = dict(max_ready=4, flow_model="cnn", table_size=128)
SERVICE_COUNTS = ("requests", "served_requests", "shed_requests", "submitted", "served", "shed",
                  "dispatches", "coalesced", "padded", "depth_hwm", "pool_hits", "pool_misses",
                  "failed_dispatches", "failed")
PIPE_COUNTS = ("packets", "steps", "flows", "new_flows", "evicted", "dispatches", "padded")


@pytest.fixture(scope="module")
def models():
    out = {}
    for kind, seed in (("mlp", 0), ("cnn", 1)):
        jp = jpm.init_paper_model(kind, jax.random.PRNGKey(seed))
        out[kind] = (jp, convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                                   device="cpu"))
    return out


def traffic(batch_size: int, seed: int, client_id: int = 0) -> dict:
    return dict(batch_size=batch_size, active_flows=8, elephant_fraction=0.4, table_size=128,
                seed=seed, client_id=client_id)


def gen_of(batch_size: int, seed: int, client_id: int = 0) -> TrafficGenerator:
    return TrafficGenerator(TrafficConfig(**traffic(batch_size, seed, client_id)), device="cpu")


def make(models, *, batch_size=32, num_shards=0, **kw):
    cfg = PipelineConfig(batch_size=batch_size, **SHAPE, **kw)
    mlp, cnn = models["mlp"][1], models["cnn"][1]
    if num_shards:
        return ShardedOctopusPipeline(mlp, cnn, cfg, num_shards=num_shards, device="cpu")
    return OctopusPipeline(mlp, cnn, cfg, device="cpu")


def make_ref(models, *, batch_size=32, num_shards=0):
    cfg = JPipelineConfig(batch_size=batch_size, **SHAPE)
    jmlp, jcnn = models["mlp"][0], models["cnn"][0]
    rc = JRuntimeConfig(use_pallas=False)
    if num_shards:
        return JShardedOctopusPipeline(jmlp, jcnn, cfg, num_shards=num_shards, config=rc)
    return JOctopusPipeline(jmlp, jcnn, cfg, config=rc)


async def script(svc, gen, stream):
    """The same submits for either package (``gen(size, seed, client)`` makes a
    generator, ``stream`` is its ``serve_stream``): a coalescing wave, an
    oversize request, an empty one, an over-budget wave, closed-loop clients
    with ragged sizes.  Returns every outcome in order."""
    out = []
    async with svc:
        out += await asyncio.gather(*(svc.submit(gen(n, i, i).next_batch(), client_id=i)
                                      for i, n in enumerate((5, 6, 7, 8))))
        out.append(await svc.submit(gen(70, 9, 4).next_batch(), client_id=4))
        empty = gen(4, 0, 0).next_batch()
        out.append(await svc.submit(type(empty)(*(a[:0] for a in empty)), client_id=5))
        out += await asyncio.gather(*(svc.submit(gen(20, 10 + i, i).next_batch(), client_id=i)
                                      for i in range(5)))
        for res in await asyncio.gather(*(stream(svc, gen(n, 20 + i, i), requests=3)
                                          for i, n in enumerate((3, 11, 17)))):
            out += res
    return out


def outcome(r):
    """A served or shed request as plain values, either package's."""
    if isinstance(r, (Rejected, JRejected)):
        return ("shed", r.client_id, r.packets, r.queue_depth, r.depth_budget)
    return ("served", r.client_id, np.asarray(r.pkt_actions).tolist(), r.bucket, r.buckets)


@pytest.mark.parametrize("num_shards,admission,offload", [
    (0, "shed", False), (0, "block", True), (2, "shed", True), (2, "block", False)],
    ids=["single-shed-inline", "single-block-offload", "sharded-shed-offload",
         "sharded-block-inline"])
@async_test
async def test_service_matches_reference(models, num_shards, admission, offload):
    kw = dict(buckets=(8, 16, 32), depth_budget=96, admission=admission, offload=offload)
    ref_pipe, pipe = make_ref(models, num_shards=num_shards), make(models, num_shards=num_shards)
    ref = JOctopusService(ref_pipe, JServiceConfig(**kw))
    svc = OctopusService(pipe, ServiceConfig(**kw))
    want = await script(ref, lambda n, s, c: JTrafficGenerator(JTrafficConfig(**traffic(n, s, c))),
                        j_serve_stream)
    got = await script(svc, gen_of, serve_stream)
    assert [outcome(r) for r in got] == [outcome(r) for r in want]
    assert any(isinstance(r, Rejected) for r in got) == (admission == "shed")
    assert pipe.rules.rules == ref_pipe.rules.rules
    for name in SERVICE_COUNTS:
        assert getattr(svc.stats, name) == getattr(ref.stats, name), name
    for name in PIPE_COUNTS:
        assert getattr(pipe.stats, name) == getattr(ref_pipe.stats, name), name
    assert svc.stats.coalesced > svc.stats.dispatches  # requests really coalesced
    assert set(svc.stats.clients) == set(ref.stats.clients)
    for cid, c in svc.stats.clients.items():
        r = ref.stats.clients[cid]
        assert (c.requests, c.submitted, c.served, c.shed) == (r.requests, r.submitted,
                                                               r.served, r.shed)
        assert len(c.wait) == len(r.wait) and len(c.e2e) == len(r.e2e)
    assert svc.queue_depth == 0


def test_service_config_validation_matches_reference():
    for kw in (dict(buckets=()), dict(buckets=(32, 16)), dict(buckets=(16, 16)),
               dict(admission="drop"), dict(depth_budget=0), dict(pool_depth=0),
               dict(batch_wait_s=-1.0)):
        with pytest.raises(ValueError) as want:
            JServiceConfig(**kw)
        with pytest.raises(ValueError) as got:
            ServiceConfig(**kw)
        assert str(got.value) == str(want.value)


@async_test
async def test_submit_before_start_raises(models):
    svc = OctopusService(make(models))
    with pytest.raises(RuntimeError, match="not started"):
        await svc.submit(gen_of(4, 0).next_batch())
    with pytest.raises(ValueError, match="pay_bytes"):
        async with svc:
            b = gen_of(4, 0).next_batch()
            await svc.submit(b._replace(payload=b.payload[:, :3]))


@pytest.mark.parametrize("num_shards", [0, 2])
def test_padded_serving_equals_unpadded_step(models, num_shards):
    """A request padded to its bucket gives the unpadded step's verdicts,
    drained rows, state and rules, whatever ``cfg.batch_size`` says."""
    b, bucket = 24, 32
    gen = gen_of(b, seed=3)
    ref = make(models, batch_size=b, num_shards=num_shards)
    padded = make(models, batch_size=99 if not num_shards else 48, num_shards=num_shards)
    padded.warm_bucket(bucket)
    for batch in gen.batches(5):
        o_ref = ref.step(batch)
        keep = torch.arange(bucket) < b
        o_pad = padded.step_masked(ft.PacketBatch(*(torch.cat([a, a.new_zeros(
            (bucket - b, *a.shape[1:]))]) for a in batch)), keep)
        assert torch.equal(o_ref.pkt_actions, o_pad.pkt_actions[:b])
        for name, x, y in zip(ft.DrainResult._fields, o_ref.drained, o_pad.drained):
            assert torch.equal(x, y), name
        for x, y in zip(ref.state, padded.state):
            assert torch.equal(x, y)
    assert ref.rules.rules == padded.rules.rules
    assert padded.stats.packets == ref.stats.packets == 5 * b
    assert padded.stats.padded == 5 * ((num_shards or 1) * bucket - b)


@async_test
async def test_dispatches_ride_warmed_buckets(models):
    """Ragged sizes over three buckets: every dispatch's bucket was warmed by
    ``start`` (the port compiles nothing, so this is what "no retrace"
    means here), and no dispatch warms a new one."""
    pipe = make(models)
    svc = OctopusService(pipe, ServiceConfig(buckets=(8, 16, 32)))
    seen = []
    plain = pipe.step_masked

    def watched(batch, keep):
        seen.append((int(batch.ts.shape[0]), set(pipe._warm_buckets)))
        return plain(batch, keep)

    pipe.step_masked = watched
    async with svc:
        warmed = set(pipe._warm_buckets)
        assert warmed == {8, 16, 32}
        for i, size in enumerate((3, 8, 11, 16, 17, 29, 32, 5, 24)):
            res = await svc.submit(gen_of(size, seed=i).next_batch())
            assert res.pkt_actions.shape == (size,) and res.bucket >= size
    assert seen and all(bucket in warmed and before == warmed for bucket, before in seen)
    assert pipe._warm_buckets == warmed
    assert svc.stats.served == 3 + 8 + 11 + 16 + 17 + 29 + 32 + 5 + 24


class _FailOnce:
    """A step that raises on its first call, then delegates."""

    def __init__(self, inner, exc):
        self.inner, self.exc, self.calls = inner, exc, 0

    def __call__(self, batch, keep):
        self.calls += 1
        if self.calls == 1:
            raise self.exc
        return self.inner(batch, keep)


@pytest.mark.parametrize("offload", [True, False])
@async_test
async def test_failing_dispatch_resolves_futures_and_service_survives(models, offload):
    pipe = make(models)
    svc = OctopusService(pipe, ServiceConfig(buckets=(8, 16, 32), offload=offload))
    async with svc:
        assert (svc._executor is None) == (not offload)
        boom = RuntimeError("injected device fault")
        pipe.step_masked = _FailOnce(pipe.step_masked, boom)
        outcomes = await asyncio.gather(
            svc.submit(gen_of(5, seed=1).next_batch(), client_id=0),
            svc.submit(gen_of(6, seed=2).next_batch(), client_id=1), return_exceptions=True)
        assert all(o is boom for o in outcomes)
        assert svc.queue_depth == 0
        assert (svc.stats.failed_dispatches, svc.stats.failed, svc.stats.served) == (1, 11, 0)
        misses = svc.stats.pool_misses
        res = await svc.submit(gen_of(11, seed=3).next_batch(), client_id=0)
        assert isinstance(res, ServeResult) and res.pkt_actions.shape == (11,)
        assert svc.stats.pool_misses == misses and svc.stats.pool_hits >= 1  # buffer returned
    assert svc.stats.served == 11
    assert svc.stats.host_s > 0 and svc.stats.device_s > 0


@async_test
async def test_failing_dispatch_unblocks_waiting_submitters(models):
    pipe = make(models)
    svc = OctopusService(pipe, ServiceConfig(buckets=(8,), depth_budget=8, admission="block"))
    async with svc:
        pipe.step_masked = _FailOnce(pipe.step_masked, RuntimeError("boom"))
        outcomes = await asyncio.gather(
            svc.submit(gen_of(8, seed=1).next_batch(), client_id=0),
            svc.submit(gen_of(8, seed=2).next_batch(), client_id=1), return_exceptions=True)
        assert isinstance(outcomes[0], RuntimeError)
        assert isinstance(outcomes[1], ServeResult)
        assert svc.queue_depth == 0


@async_test
async def test_wall_clock_and_latency_stats(models):
    """Per-client and global latency samples from closed-loop clients; the
    wall clock ticks between reads and freezes at stop; idle percentiles
    are nan."""
    pipe = make(models, num_shards=2)
    svc = OctopusService(pipe, ServiceConfig(buckets=(8, 16, 32)))
    assert math.isnan(svc.stats.wait.p50) and math.isnan(svc.stats.host_us)
    async with svc:
        gens = [gen_of(n, seed=i, client_id=i) for i, n in enumerate((6, 11, 23))]
        outs = await asyncio.gather(*(serve_stream(svc, g, requests=4) for g in gens))
        w1, r1 = svc.stats.wall_s, svc.stats.pkt_per_s
        await asyncio.sleep(0.05)
        assert svc.stats.wall_s >= w1 + 0.04 and svc.stats.pkt_per_s < r1
    frozen = svc.stats.wall_s
    await asyncio.sleep(0.02)
    assert svc.stats.wall_s == frozen
    for res_list, g in zip(outs, gens):
        for r in res_list:
            assert r.client_id == g.client_id and 0 <= r.queue_wait_s <= r.e2e_s
    s = svc.stats
    assert set(s.clients) == {0, 1, 2} and len(s.wait) == 12 and s.e2e.p99 > 0
    for c in s.clients.values():
        assert c.requests == 4 and c.served == c.submitted and len(c.e2e) == 4
    assert math.isfinite(s.host_us) and math.isfinite(s.device_us) and pipe.stats.p99_us > 0
