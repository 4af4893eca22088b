"""The port's offline feature extractor (``ExtractorConfig``/``FeatureExtractor``),
its packet trace (``data/packets.py``) and the per-granularity paths
(``PacketPath``/``FlowPath``, ``PacketEngine.decide``) against the JAX
package's on the same seeds and converted reference weights: traces leaf by
leaf, tracker states and step outputs bit for bit, verdicts, classes and rule
tables exactly; the refusals with the reference's messages.

The reference's Pallas arm of ``extract_scan`` does not run on the installed
JAX (``pl.load``), so the port's ``extract_scan`` under ``use_pallas`` (the
feature lanes replayed through the ALU fold) is held to the reference's plain
``extract_scan``: the two are identical by construction.  The reference runs
are shared through module-scoped fixtures."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st

from repro.core import feature_extractor as jfx
from repro.core import flow_tracker as jft
from repro.data.packets import PacketTraceConfig as JPacketTraceConfig
from repro.data.packets import synth_packet_trace as j_synth_packet_trace
from repro.models import paper_models as jpm
from repro.runtime import RuntimeConfig as JRuntimeConfig
from repro.serving import packet_path as jpp
from repro_torch import convert
from repro_torch.core import flow_tracker as ft
from repro_torch.core.feature_extractor import (
    ExtractorConfig,
    FeatureExtractor,
    derive_whole_features,
    segmented_update,
)
from repro_torch.data import PacketTraceConfig, synth_packet_trace
from repro_torch.kernels.flow_features.ops import HIST
from repro_torch.models import paper_models
from repro_torch.runtime import RuntimeConfig
from repro_torch.serving import FlowEngine, FlowPath, PacketEngine, PacketPath, PathStats

# (trace config, extractor config) of the reference tests' traces
TRACES = {
    "spread": (dict(num_flows=50, pkts_per_flow=8, seed=3, table_size=512),
               dict(table_size=512, top_n=8, top_k=4)),
    "colliding": (dict(num_flows=40, pkts_per_flow=6, seed=7, table_size=16,
                       collision_free=False), dict(table_size=16, top_n=6, top_k=4)),
    "evicting": (dict(num_flows=30, pkts_per_flow=6, seed=11, table_size=32,
                      collision_free=False), dict(table_size=32, top_n=6, top_k=4)),
}


def assert_tuple_equal(want, got, what: str) -> None:
    for name, a, b in zip(want._fields, want, got):
        np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy(), err_msg=f"{what}.{name}")


def port_trace(name: str) -> ft.PacketBatch:
    return synth_packet_trace(PacketTraceConfig(**TRACES[name][0]), device="cpu")[0]


@pytest.fixture(scope="module")
def ref_runs():
    """Per trace: the reference's packets, its scan (state, outs) from an
    empty table and its segmented extraction."""
    out = {}
    for name, (tcfg, xcfg) in TRACES.items():
        packets = j_synth_packet_trace(JPacketTraceConfig(**tcfg))[0]
        ex = jfx.FeatureExtractor(jfx.ExtractorConfig(**xcfg))
        out[name] = (packets, ex.extract_scan(ex.init_state(), packets),
                     ex.extract_segmented(packets))
    return out


# ---------------------------------------------------------------------------
# the packet trace
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(num_flows=20, pkts_per_flow=5, seed=0, table_size=256),
    dict(num_flows=64, pkts_per_flow=2, seed=1, table_size=1024),
    dict(num_flows=40, pkts_per_flow=6, seed=7, table_size=16, collision_free=False),
    dict(num_flows=12, pkts_per_flow=9, seed=4, num_classes=3, pay_bytes=5,
         malicious_fraction=0.6),
], ids=["small", "collision_free", "colliding", "odd_widths"])
def test_packet_trace_matches_the_reference(kw):
    want = j_synth_packet_trace(JPacketTraceConfig(**kw))
    got = synth_packet_trace(PacketTraceConfig(**kw), device="cpu")
    assert_tuple_equal(want[0], got[0], "PacketBatch")
    for a, b in zip(want[1:], got[1:]):
        np.testing.assert_array_equal(np.asarray(a), b)
        assert b.dtype == np.int32
    packets, classes, hashes, labels = got
    n = kw["num_flows"] * kw["pkts_per_flow"]
    assert packets.ts.shape == (n,) and packets.payload.shape == (n, kw.get("pay_bytes", 16))
    assert bool((packets.ts[1:] >= packets.ts[:-1]).all())  # arrival order
    assert classes.shape == hashes.shape == labels.shape == (kw["num_flows"],)
    if kw.get("collision_free", True):
        slots = ft.hash_slot(torch.from_numpy(hashes), kw.get("table_size", 8192))
        assert slots.unique().numel() == kw["num_flows"]


def test_packet_trace_defaults_to_the_card():
    assert PacketTraceConfig() == PacketTraceConfig(**vars(JPacketTraceConfig()))
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synth_packet_trace(PacketTraceConfig(num_flows=2, pkts_per_flow=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FeatureExtractor()


# ---------------------------------------------------------------------------
# the extractor
# ---------------------------------------------------------------------------

def make_extractor(**kw) -> FeatureExtractor:
    return FeatureExtractor(ExtractorConfig(**kw), device="cpu")


def small_batch(hashes, ts, size, **kw) -> tuple[ft.PacketBatch, jft.PacketBatch]:
    n = len(hashes)
    leaves = dict(ts=ts, size=size, dir=kw.get("dir", [0] * n), flags=kw.get("flags", [0] * n),
                  proto=kw.get("proto", [0] * n), tuple_hash=hashes)
    port = ft.PacketBatch(**{k: torch.tensor(v, dtype=torch.int32) for k, v in leaves.items()},
                          payload=torch.zeros((n, 16), dtype=torch.int32))
    ref = jft.PacketBatch(**{k: jnp.asarray(v, jnp.int32) for k, v in leaves.items()},
                          payload=jnp.zeros((n, 16), jnp.int32))
    return port, ref


def test_extractor_config_matches_the_reference():
    want = jfx.ExtractorConfig()
    got = ExtractorConfig()
    for name in ("table_size", "top_n", "top_k", "pay_bytes", "use_pallas"):
        assert getattr(got, name) == getattr(want, name), name
    assert not hasattr(got, "interpret")  # the tensor's device picks the kernel


@pytest.mark.parametrize("use_pallas", [False, True])
def test_flow_establish_ready_and_features(use_pallas):
    ex = make_extractor(table_size=64, top_n=3, use_pallas=use_pallas)
    jex = jfx.FeatureExtractor(jfx.ExtractorConfig(table_size=64, top_n=3))
    port, ref = small_batch([7, 7, 7, 9], [10, 20, 30, 40], [100, 200, 300, 50],
                            dir=[0, 1, 0, 0], flags=[1, 2, 4, 8], proto=[1, 1, 1, 2])
    st, outs = ex.extract_scan(ex.init_state(), port)
    jst, jouts = jex.extract_scan(jex.init_state(), ref)
    assert_tuple_equal(jst, st, "TrackerState")
    assert_tuple_equal(jouts, outs, "StepOut")
    assert outs.new_flow.tolist() == [True, False, False, True]
    assert outs.ready.tolist() == [False, False, True, False]
    feats = st.features[int(outs.slot[0])]
    assert [int(feats[HIST[k]]) for k in ("pkt_count", "flow_size", "flow_dur", "max_size",
                                           "min_size", "size_fwd", "size_bwd")] == [
        3, 600, 20, 300, 100, 400, 200]
    assert st.series[int(outs.slot[0])][:3].tolist() == [0, 10, 10]


def test_collision_evicts_and_release_recycles():
    ex = make_extractor(table_size=8, top_n=5)
    base = ft.hash_slot_scalar(123, 8)
    h1, h2 = [t for t in range(200, 400) if ft.hash_slot_scalar(t, 8) == base][:2]
    port, ref = small_batch([h1, h2, h2], [1, 2, 3], [10, 20, 30])
    st, outs = ex.extract_scan(ex.init_state(), port)
    jex = jfx.FeatureExtractor(jfx.ExtractorConfig(table_size=8, top_n=5))
    jst, jouts = jex.extract_scan(jex.init_state(), ref)
    assert_tuple_equal(jst, st, "TrackerState")
    assert outs.evicted.tolist() == [False, True, False]
    slot = int(outs.slot[0])
    assert int(st.features[slot][HIST["pkt_count"]]) == 2  # only h2's packets
    released = ft.release_flows(st, torch.tensor([slot]))
    assert_tuple_equal(jft.release_flows(jst, jnp.asarray([slot])), released, "released")
    assert int(released.count[slot]) == 0


@pytest.mark.parametrize("name", sorted(TRACES))
@pytest.mark.parametrize("use_pallas", [False, True])
def test_extract_scan_matches_the_reference(ref_runs, name, use_pallas):
    """Both arms of the port's extract_scan equal the reference's plain scan:
    state and step outputs, establish and evict included."""
    _, (jst, jouts), _ = ref_runs[name]
    ex = make_extractor(**TRACES[name][1], use_pallas=use_pallas)
    st, outs = ex.extract_scan(ex.init_state(), port_trace(name))
    assert_tuple_equal(jst, st, "TrackerState")
    assert_tuple_equal(jouts, outs, "StepOut")
    if name != "spread":
        assert bool(outs.evicted.any())  # a slot re-establishes within the trace


@pytest.mark.parametrize("name", sorted(TRACES))
def test_extract_segmented_matches_the_reference(ref_runs, name):
    """The segmented extraction from an empty table equals the reference's,
    and the scan's on every leaf; colliding traces take the fallback."""
    _, (jst, _), want = ref_runs[name]
    ex = make_extractor(**TRACES[name][1])
    got = ex.extract_segmented(port_trace(name))
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f"leaf {i}")
    for a, b in zip((jst.features, jst.series, jst.sizes, jst.payload, jst.count), got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    _, seg = ex.segmented_update(ex.init_state(), port_trace(name))
    assert (int(seg.fallback_slots) > 0) == (name != "spread")


@pytest.mark.parametrize("name", ["spread", "colliding"])
def test_segmented_update_composes_with_live_state(name):
    """Scan the first half, merge the second into the live table: state and
    event counts equal the reference's segmented merge and its scan."""
    tcfg, xcfg = TRACES[name]
    jpackets = j_synth_packet_trace(JPacketTraceConfig(**tcfg))[0]
    packets = port_trace(name)
    half = int(packets.ts.shape[0]) // 2
    jex = jfx.FeatureExtractor(jfx.ExtractorConfig(**xcfg))
    ex = make_extractor(**xcfg)
    first = jax.tree_util.tree_map(lambda a: a[:half], jpackets)
    second = jax.tree_util.tree_map(lambda a: a[half:], jpackets)
    jmid, _ = jft.process_packets(jex.init_state(), first, jex.program, top_n=xcfg["top_n"])
    jscan, jouts = jft.process_packets(jmid, second, jex.program, top_n=xcfg["top_n"])
    jseg, jsegout = jex.segmented_update(jmid, second)
    mid, _ = ex.extract_scan(ex.init_state(), ft.PacketBatch(*(a[:half] for a in packets)))
    assert_tuple_equal(jmid, mid, "mid")
    seg_state, seg = ex.segmented_update(mid, ft.PacketBatch(*(a[half:] for a in packets)))
    assert_tuple_equal(jseg, seg_state, "segmented")
    assert_tuple_equal(jscan, seg_state, "scan")
    assert_tuple_equal(jsegout, seg, "SegmentedOut")
    assert int(seg.new_flows) == int(np.asarray(jouts.new_flow).sum())
    assert int(seg.evicted) == int(np.asarray(jouts.evicted).sum())


def test_custom_program_refused_without_use_pallas():
    """Without use_pallas the extractor takes only the default program, with
    the reference's message; with it any program folds, equal to the
    reference's scan under that program."""
    tcfg = dict(num_flows=4, pkts_per_flow=2, seed=0, table_size=32)
    jpackets = j_synth_packet_trace(JPacketTraceConfig(**tcfg))[0]
    packets = synth_packet_trace(PacketTraceConfig(**tcfg), device="cpu")[0]
    custom = np.zeros((16, 3), np.int32)
    custom[:, 0] = [2, 6, 4, 5, 3, 1, 0, 2, 2, 2, 4, 1, 3, 5, 6, 1]
    custom[:, 1] = np.arange(16) % 13
    custom[:, 2] = (np.arange(16) * 5 + 3) % 16
    jex = jfx.FeatureExtractor(jfx.ExtractorConfig(table_size=32, top_n=4, top_k=4),
                               program=jnp.asarray(custom))
    with pytest.raises(ValueError) as theirs:
        jfx.segmented_update(jex.init_state(), jpackets, jnp.asarray(custom), top_n=4)
    cfg = dict(table_size=32, top_n=4, top_k=4)
    ex = FeatureExtractor(ExtractorConfig(**cfg), torch.from_numpy(custom), device="cpu")
    with pytest.raises(ValueError) as ours:
        ex.extract_segmented(packets)
    assert str(ours.value) == str(theirs.value) and "use_pallas" in str(ours.value)
    ex = FeatureExtractor(ExtractorConfig(**cfg, use_pallas=True), torch.from_numpy(custom),
                          device="cpu")
    want, _ = jex.extract_scan(jex.init_state(), jpackets)
    got, _ = ex.segmented_update(ex.init_state(), packets)
    assert_tuple_equal(want, got, "custom program")
    scanned, _ = ex.extract_scan(ex.init_state(), packets)
    assert_tuple_equal(want, scanned, "custom program, replayed")
    # the port's module-level merge is the ALU fold alone: it takes any program
    merged, _ = segmented_update(ex.init_state(), packets, torch.from_numpy(custom), top_n=4)
    assert_tuple_equal(want, merged, "custom program, module-level merge")


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 1000), nflows=st.integers(2, 30), npkts=st.integers(1, 10),
       collision_free=st.booleans(), use_pallas=st.booleans())
def test_segmented_equals_scan_property(seed, nflows, npkts, collision_free, use_pallas):
    table = 256 if collision_free else 16  # a small table forces collisions
    packets = synth_packet_trace(PacketTraceConfig(
        num_flows=nflows, pkts_per_flow=npkts, seed=seed, table_size=table,
        collision_free=collision_free), device="cpu")[0]
    ex = make_extractor(table_size=table, top_n=max(npkts, 2), top_k=2, use_pallas=use_pallas)
    st_scan, _ = ex.extract_scan(ex.init_state(), packets)
    feats, series, sizes, payload, counts = ex.extract_segmented(packets)
    for a, b in zip((st_scan.features, st_scan.count, st_scan.series, st_scan.sizes,
                     st_scan.payload), (feats, counts, series, sizes, payload)):
        assert torch.equal(a, b)


def test_derive_whole_features_matches_the_reference():
    ex = make_extractor(table_size=32, top_n=4)
    port, ref = small_batch([5, 5, 5], [0, 10, 30], [100, 300, 200], dir=[0, 1, 0],
                            flags=[1, 1, 1], proto=[1, 1, 1])
    st, outs = ex.extract_scan(ex.init_state(), port)
    w = derive_whole_features(st.features[int(outs.slot[0])])
    assert w[:6].tolist() == [30, 3, 600, 200, 300, 100] and w[9:11].tolist() == [300, 300]
    jex = jfx.FeatureExtractor(jfx.ExtractorConfig(table_size=32, top_n=4))
    jst, _ = jex.extract_scan(jex.init_state(), ref)
    np.testing.assert_array_equal(np.asarray(jfx.derive_whole_features(jst.features)),
                                  derive_whole_features(st.features).numpy())


# ---------------------------------------------------------------------------
# the packet and flow paths
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    out = {}
    for kind, seed in (("mlp", 0), ("cnn", 1), ("transformer", 2)):
        jp = jpm.init_paper_model(kind, jax.random.PRNGKey(seed))
        out[kind] = (jp, convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                                   device="cpu"))
    return out


def trace_packets(n: int):
    """The first ``n`` packets of a seeded trace, in both packages."""
    kw = dict(num_flows=64, pkts_per_flow=20, seed=5)
    want = jax.tree_util.tree_map(lambda a: a[:n], j_synth_packet_trace(
        JPacketTraceConfig(**kw))[0])
    got = ft.PacketBatch(*(a[:n] for a in synth_packet_trace(PacketTraceConfig(**kw),
                                                             device="cpu")[0]))
    return want, got


def test_path_stats_empty_split_and_record():
    s = PathStats()
    assert math.isnan(s.latency_us) and math.isnan(s.host_us) and math.isnan(s.device_us)
    assert s.throughput == 0.0
    s.record(1.0, 10, host_s=0.25, device_s=0.75)
    lat = s.latency_us
    s.record(5.0, 0)  # an empty submit does not skew the mean
    s.record(1.0, 10, host_s=0.5, device_s=0.5)
    assert (s.calls, s.items, lat) == (2, 20, 1e6)
    assert s.host_us == pytest.approx(0.375e6) and s.device_us == pytest.approx(0.625e6)


@pytest.mark.parametrize("batch", [1, 8, 100])
def test_packet_path_matches_the_reference(models, batch):
    jmlp, mlp = models["mlp"]
    want_packets, packets = trace_packets(batch)
    ref = jpp.PacketPath(jmlp)
    path = PacketPath(mlp, device="cpu")
    path.warmup(batch)
    for _ in range(2):
        want = ref.process(want_packets)
        got = path.process(packets)
        np.testing.assert_array_equal(want, got)
        assert got.dtype == np.int32
    assert path.rules.rules == ref.rules.rules and path.rules.generation == 2
    s = path.stats
    assert (s.calls, s.items) == (2, 2 * batch)
    assert s.total_s == pytest.approx(s.host_s + s.device_s)
    assert s.latency_us > 0 and s.throughput > 0
    x = paper_models.MLP_DIMS[0]
    feats = torch.from_numpy(np.random.default_rng(batch).normal(0, 50, (batch, x))
                             .astype(np.float32))
    np.testing.assert_array_equal(
        np.asarray(jpp.PacketEngine(jmlp).decide(jmlp, jnp.asarray(feats.numpy()))),
        PacketEngine(mlp).decide(mlp, feats).numpy())


@pytest.mark.parametrize("model,flows", [("cnn", 3), ("cnn", 40), ("transformer", 16)])
def test_flow_path_matches_the_reference(models, model, flows):
    jparams, params = models[model]
    rng = np.random.default_rng(flows)
    engine = FlowEngine(params, model)
    series = torch.from_numpy(rng.integers(0, 5000, (flows, paper_models.CNN_SEQ))
                              .astype(np.int32))
    payload = torch.from_numpy(rng.integers(0, 256, (flows, paper_models.TF_PKTS,
                                                     paper_models.TF_BYTES)).astype(np.int32))
    x = engine.prep(series, payload)
    ids = rng.integers(1, 2**31 - 1, flows).astype(np.int32)
    ref = jpp.FlowPath(jparams, model=model)
    path = FlowPath(params, model=model, device="cpu")
    path.warmup(flows)
    want = ref.process(jnp.asarray(x.numpy()), ids)
    got = path.process(x, ids)
    np.testing.assert_array_equal(want, got)
    assert path.rules.rules == ref.rules.rules
    assert (path.stats.calls, path.stats.items) == (1, flows)
    assert path.stats.total_s == pytest.approx(path.stats.host_s + path.stats.device_s)


def test_empty_submit_records_nothing(models):
    p = PacketPath(models["mlp"][1], device="cpu")
    assert p.process(trace_packets(0)[1]).shape == (0,)
    assert p.stats.calls == 0 and math.isnan(p.stats.latency_us) and p.rules.generation == 0
    f = FlowPath(models["cnn"][1], model="cnn", device="cpu")
    cls = f.process(torch.zeros((0, paper_models.CNN_SEQ)), np.zeros((0,), np.int32))
    assert cls.shape == (0,) and f.stats.calls == 0 and f.rules.generation == 0
    p.process(trace_packets(4)[1])
    assert (p.stats.calls, p.stats.items) == (1, 4) and p.stats.latency_us > 0


def test_paths_share_engine_state_and_plan_as_the_reference(models):
    cfg = RuntimeConfig(policy="arype_only")
    p = PacketPath(models["mlp"][1], config=cfg, device="cpu")
    assert p.runtime is p.engine.runtime and p.runtime.policy == "arype_only"
    assert p.params is p.engine.params
    jp = jpp.PacketPath(models["mlp"][0], config=JRuntimeConfig(policy="arype_only"))
    for mine, theirs in ((p.route_plan(batch=8), jp.route_plan(batch=8)),):
        assert [(s.name, s.engine) for s in mine.steps] == [(s.name, s.engine)
                                                             for s in theirs.steps]
        assert all(s.engine == "arype" for s in mine.steps)
    f = FlowPath(models["cnn"][1], model="cnn", config=cfg, device="cpu")
    jf = jpp.FlowPath(models["cnn"][0], model="cnn", config=JRuntimeConfig(policy="arype_only"))
    assert f.model == "cnn" and f.runtime.policy == "arype_only"
    assert len(f.route_plan(flows=10)) == len(jf.route_plan(flows=10)) == 5
    with pytest.raises(ValueError, match="model"):
        FlowPath(models["cnn"][1], model="rnn", device="cpu")
