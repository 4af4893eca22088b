"""The port's dispatch modes of ``OctopusPipeline`` against its eager loop and
the JAX package's: ``step_many`` (``scan_len > 1``), deferred-sync
``overlap`` with its ``InflightDispatch`` handles and the double-buffered
``run``, the traffic ``prefetch``, and the masked bucket entry point
(``warm_bucket``/``step_masked``).  Every mode must leave the same tracker
state, outputs, rule table and counters as the eager loop, bit for bit.

The JAX pipelines run without ``use_pallas``; traffic comes from the port's
generator, which draws the reference's packets for a seed."""
import math

import jax
import numpy as np
import pytest
import torch

from repro.data.traffic import TrafficConfig as JTrafficConfig
from repro.data.traffic import TrafficGenerator as JTrafficGenerator
from repro.models import paper_models as jpm
from repro.runtime import RuntimeConfig as JRuntimeConfig
from repro.serving import OctopusPipeline as JOctopusPipeline
from repro.serving import PipelineConfig as JPipelineConfig
from repro_torch import convert
from repro_torch.core import feature_extractor as fx
from repro_torch.core import flow_tracker as ft
from repro_torch.data.traffic import TrafficConfig, TrafficGenerator, prefetch
from repro_torch.serving import OctopusPipeline, PipelineConfig
from repro_torch.serving.pipeline import InflightDispatch

SHAPE = dict(batch_size=16, max_ready=8, table_size=128)
TRAFFIC = dict(batch_size=16, active_flows=8, elephant_fraction=0.5, table_size=128, seed=7)
COUNTS = ("packets", "steps", "flows", "new_flows", "evicted", "spilled", "promoted",
          "fallback_steps", "dispatches", "padded")


@pytest.fixture(scope="module")
def models():
    out = {}
    for kind, seed in (("mlp", 0), ("cnn", 1)):
        jp = jpm.init_paper_model(kind, jax.random.PRNGKey(seed))
        out[kind] = (jp, convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                                   device="cpu"))
    return out


def make(models, **kw):
    return OctopusPipeline(models["mlp"][1], models["cnn"][1], PipelineConfig(**SHAPE, **kw),
                           device="cpu")


def gen(seed: int = 7, **kw):
    return TrafficGenerator(TrafficConfig(**dict(TRAFFIC, seed=seed, **kw)), device="cpu")


def assert_trees_equal(a, b, what: str):
    if isinstance(a, torch.Tensor):
        np.testing.assert_array_equal(np.asarray(b), a.numpy(), err_msg=what)
        return
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        assert_trees_equal(x, y, f"{what}[{i}]")


def assert_runs_identical(eager, other, steps: int, **traffic):
    se = eager.run(gen(**traffic), steps=steps)
    so = other.run(gen(**traffic), steps=steps)
    assert_trees_equal(eager.state, other.state, "state")
    assert eager.rules.rules == other.rules.rules
    assert eager.rules.generation == other.rules.generation
    for name in COUNTS:
        assert getattr(se, name) == getattr(so, name), name
    assert so.packets == steps * SHAPE["batch_size"] and so.steps == steps


def test_step_many_matches_reference_and_scan_len_1(models):
    """Three chunks of scan_len 3: the stacked outputs equal the reference's
    step_many, the state and rules equal the reference's and the port's own
    scan_len 1 loop; one dispatch a chunk."""
    (jmlp, _), (jcnn, _) = models["mlp"], models["cnn"]
    jpipe = JOctopusPipeline(jmlp, jcnn, JPipelineConfig(**SHAPE, scan_len=3),
                             config=JRuntimeConfig(use_pallas=False))
    chunked, single = make(models, scan_len=3), make(models)
    jgen = JTrafficGenerator(JTrafficConfig(**TRAFFIC))
    g_chunk, g_single = gen(), gen()
    for chunk in range(3):
        jout = jpipe.step_many([jgen.next_batch() for _ in range(3)])
        out = chunked.step_many([g_chunk.next_batch() for _ in range(3)])
        assert out.pkt_actions.shape == (3, SHAPE["batch_size"])
        assert out.drained.series.shape == (3, SHAPE["max_ready"], 20)
        for name in ("pkt_actions", "flow_actions", "flow_cls", "new_flows", "evicted",
                     "spilled", "promoted"):
            np.testing.assert_array_equal(np.asarray(getattr(jout, name)),
                                          getattr(out, name).numpy(), err_msg=name)
        assert_trees_equal(out.drained, jout.drained, f"chunk {chunk} drained")
        np.testing.assert_allclose(np.asarray(jout.flow_scores), out.flow_scores.numpy(),
                                   rtol=1e-5, atol=1e-6)
        singles = [single.step(g_single.next_batch()) for _ in range(3)]
        for j, s in enumerate(singles):
            assert_trees_equal(s.drained, [leaf[j] for leaf in out.drained], "drained")
            assert torch.equal(s.pkt_actions, out.pkt_actions[j])
    assert_trees_equal(chunked.state, jpipe.state, "state")
    assert_trees_equal(chunked.state, single.state, "state")
    assert chunked.rules.rules == jpipe.rules.rules == single.rules.rules
    assert chunked.stats.flows == jpipe.stats.flows > 0
    assert (chunked.stats.steps, chunked.stats.dispatches) == (9, 3)
    assert single.stats.dispatches == 9
    with pytest.raises(ValueError, match="scan_len=3"):
        chunked.step_many([g_chunk.next_batch()] * 2)


@pytest.mark.parametrize("scan_len,steps,cold", [
    (1, 9, 0),  # one step a dispatch
    (3, 9, 0),  # chunks only
    (3, 8, 0),  # chunks and a partial final chunk, step by step
    (2, 7, 48),  # two-level table on colliding traffic
], ids=["step", "chunks", "partial", "two_level"])
def test_overlap_is_bit_identical_to_eager(models, scan_len, steps, cold):
    kw = dict(scan_len=scan_len, cold_size=cold)
    traffic = dict(collision_free=False, active_flows=160) if cold else {}
    eager, ovl = make(models, **kw), make(models, overlap=True, **kw)
    eager.warmup()
    ovl.warmup()
    assert_runs_identical(eager, ovl, steps, **traffic)
    if cold:
        assert ovl.stats.spilled > 0 and ovl.stats.promoted > 0
    assert ovl.stats.dispatches == steps // scan_len + steps % scan_len


def test_overlap_stepwise_outputs_equal_eager(models):
    """Handles waited one behind the wire (what ``run`` does) return every
    step's eager outputs."""
    eager, ovl = make(models), make(models, overlap=True)
    batches = list(gen().batches(6))
    eager_outs = [eager.step(b) for b in batches]
    ovl_outs, pending = [], None
    for b in batches:
        h = ovl.step(b)
        assert isinstance(h, InflightDispatch)
        if pending is not None:
            ovl_outs.append(pending.wait())
        pending = h
    ovl_outs.append(pending.wait())
    for e, o in zip(eager_outs, ovl_outs):
        assert_trees_equal(e, o, "step output")
    assert eager.rules.rules == ovl.rules.rules


def test_handle_contract(models):
    """Feedback and stats wait for ``wait``; ``wait`` is idempotent and
    records the dispatch once; eager mode returns outputs."""
    p = make(models, overlap=True)
    g = gen()
    before = p.rules.generation
    h = p.step(g.next_batch())
    assert isinstance(h, InflightDispatch) and not h.done
    assert (h.steps, h.packets) == (1, SHAPE["batch_size"])
    assert p.rules.generation == before and p.stats.dispatches == 0
    h.add_host_time(0.5)
    out1, out2 = h.wait(), h.wait()
    assert out1 is out2 and h.done
    assert (p.stats.dispatches, p.stats.steps) == (1, 1)
    assert p.rules.generation > before and p.stats.host_s >= 0.5
    eager = make(models, scan_len=2)
    out = eager.step_many([g.next_batch(), g.next_batch()])
    assert not isinstance(out, InflightDispatch) and out.pkt_actions.shape == (2, 16)


def test_stats_split_host_and_device(models):
    for overlap in (False, True):
        p = make(models, overlap=overlap)
        s = p.run(gen(), steps=5)
        assert s.total_s == pytest.approx(s.host_s + s.device_s)
        assert s.host_s > 0 and s.device_s >= 0
        assert math.isfinite(s.host_us) and math.isfinite(s.device_us)
        assert math.isfinite(s.dispatch_us) and s.lat.total_added == 5
    idle = make(models, overlap=True).stats
    assert math.isnan(idle.host_us) and math.isnan(idle.dispatch_us)


def test_prefetch_keeps_order_and_passes_tuples():
    src = list(gen().batches(12))
    out = list(prefetch(iter(src), depth=3))
    assert len(out) == len(src)
    for a, b in zip(src, out):
        assert_trees_equal(a, b, "prefetched batch")
    pairs = [(0, "a"), (1, "b")]  # a 2-tuple of the stream is not the end marker
    assert list(prefetch(iter(pairs), depth=1)) == pairs


def test_prefetch_raises_the_producer_error_and_refuses_bad_depth():
    def boom():
        yield 1
        yield 2
        raise RuntimeError("producer died")

    it = prefetch(boom(), depth=2)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(RuntimeError, match="producer died"):
        next(it)
    with pytest.raises(ValueError, match="depth"):
        next(prefetch(iter([]), depth=0))


def test_prefetch_keeps_every_item_under_fast_thread_switching():
    """The queue hand-off loses and reorders nothing when the interpreter
    switches threads every microsecond; the producer ends with the stream."""
    import sys
    import threading

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for depth in (1, 4):
            assert list(prefetch(iter(range(3000)), depth=depth)) == list(range(3000))
    finally:
        sys.setswitchinterval(interval)
    for t in threading.enumerate():
        if t.name == "traffic-prefetch":
            t.join(timeout=10)
            assert not t.is_alive()


def test_prefetched_overlapped_run_is_bit_identical(models):
    a, b = make(models, overlap=True, scan_len=2), make(models, overlap=True, scan_len=2)
    a.run(gen(), steps=8)
    b.run(prefetch(gen().batches(8), depth=2), steps=8)
    assert_trees_equal(a.state, b.state, "state")
    assert a.rules.rules == b.rules.rules and a.stats.packets == b.stats.packets == 128


def test_step_masked_matches_reference_and_kept_rows(models):
    """Ragged batches padded to buckets: the state equals the reference's
    masked step and the port's tracker fed only the kept rows; the outputs
    equal the reference's, padding is counted and left out of the rules."""
    (jmlp, _), (jcnn, _) = models["mlp"], models["cnn"]
    jpipe = JOctopusPipeline(jmlp, jcnn, JPipelineConfig(**SHAPE),
                             config=JRuntimeConfig(use_pallas=False))
    pipe = make(models)
    pipe.warm_bucket(32)
    pipe.warm_bucket(32)  # idempotent
    assert pipe._warm_buckets == {32} and pipe.stats.steps == 0
    with pytest.raises(ValueError, match="bucket"):
        pipe.warm_bucket(0)
    rng = np.random.default_rng(3)
    g = gen(batch_size=32)
    kept_state = ft.init_state(128, 20, 15, 16, device="cpu")
    padded = 0
    for step in range(6):
        bucket = (32, 64)[step % 2]
        batch = g.next_batch() if bucket == 32 else ft.PacketBatch(
            *(torch.cat([a, b]) for a, b in zip(g.next_batch(), g.next_batch())))
        keep = rng.random(bucket) < 0.6
        padded += bucket - int(keep.sum())
        jout = jpipe.step_masked(ft.PacketBatch(*(a.numpy() for a in batch)), keep)
        out = pipe.step_masked(batch, torch.as_tensor(keep))
        for name in ("pkt_actions", "flow_cls", "new_flows", "evicted"):
            np.testing.assert_array_equal(np.asarray(getattr(jout, name)),
                                          getattr(out, name).numpy(), err_msg=name)
        assert_trees_equal(out.drained, jout.drained, "drained")
        assert_trees_equal(pipe.state, jpipe.state, f"step {step} state")
        kept = ft.PacketBatch(*(a[torch.as_tensor(keep)] for a in batch))
        kept_state, _ = fx.segmented_update(kept_state, kept, top_n=20)
        kept_state, _ = ft.drain_ready(kept_state, top_n=20, max_ready=8)
        assert_trees_equal(pipe.state, kept_state, f"step {step} kept rows")
    assert pipe.rules.rules == jpipe.rules.rules
    for name in ("packets", "padded", "flows", "dispatches", "steps"):
        assert getattr(pipe.stats, name) == getattr(jpipe.stats, name), name
    assert pipe.stats.padded == padded and pipe._warm_buckets == {32, 64}
    with pytest.raises(ValueError, match="keep"):
        pipe.step_masked(g.next_batch(), np.ones(5, bool))
