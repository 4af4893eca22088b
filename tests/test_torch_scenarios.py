"""The port's pluggable heads, attack traffic modes, ``merge_streams`` and
scenarios (``repro_torch.core.decisions``, ``repro_torch.data.traffic``,
``repro_torch.scenarios``) against the JAX package's on the same seeds and
converted reference weights: the heads' actions and classes exactly and
their scores within rtol 1e-5; every attack mode's batches leaf by leaf;
the heavy-hitter top-k lists, tracker states, denied sets, emission lists
(scores within rtol 1e-5) and rule tables exactly; the refusals with the
reference's messages.  The hypothesis properties (hysteresis churn, per-client
order under ``merge_streams``) run on the port alone.

The JAX pipelines run without ``use_pallas`` (its Pallas flow kernel does
not run on the installed JAX); the DDoS band is taken once from the
reference's probe run, in a module-scoped fixture."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st

from repro.core import decisions as jdec
from repro.core import flow_tracker as jft
from repro.data import traffic as jtraffic
from repro.models import paper_models as jpm
from repro import scenarios as jsc
from repro.serving import OctopusPipeline as JOctopusPipeline
from repro.serving import PipelineConfig as JPipelineConfig
from repro_torch import convert
from repro_torch.core import decisions
from repro_torch.core import flow_tracker as ft
from repro_torch.data.traffic import TrafficConfig, TrafficGenerator, merge_streams, shard_of
from repro_torch.kernels.flow_features.ops import HIST
from repro_torch.runtime import record_routes
from repro_torch.scenarios import (
    AdversarialScenario,
    DDoSScenario,
    HeavyHitterScenario,
    HysteresisController,
    adversarial_config,
    top_k_flows,
)
from repro_torch.scenarios import SCENARIOS
from repro_torch.scenarios.adversarial import ATTACKS
from repro_torch.serving import OctopusPipeline, PipelineConfig

DENY, MARK = decisions.ACTIONS.index("deny"), decisions.ACTIONS.index("mark")


@pytest.fixture(scope="module")
def models():
    out = {}
    for kind, seed in (("mlp", 0), ("cnn", 1)):
        jp = jpm.init_paper_model(kind, jax.random.PRNGKey(seed))
        out[kind] = (jp, convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                                   device="cpu"))
    return out


def weights(models, *, port: bool) -> dict:
    i = 1 if port else 0
    return dict(pkt_params=models["mlp"][i], flow_params=models["cnn"][i])


def assert_batches_equal(want, got, what: str) -> None:
    for name, a, b in zip(want._fields, want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f"{what}.{name}")


def assert_states_equal(want, got, what: str) -> None:
    """A reference state (hot-only, two-level or lane-stacked) against the
    port's, leaf by leaf."""
    for name, a, b in zip(want._fields, want, got):
        if isinstance(a, tuple):
            assert_states_equal(a, b, f"{what}.{name}")
        else:
            np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy(),
                                          err_msg=f"{what}.{name}")


def same_error(make_ours, make_theirs) -> None:
    """Both raise ValueError with the same message."""
    with pytest.raises(ValueError) as theirs:
        make_theirs()
    with pytest.raises(ValueError) as ours:
        make_ours()
    assert str(ours.value) == str(theirs.value)


def test_scenario_names():
    assert SCENARIOS == jsc.SCENARIOS
    assert ATTACKS == jsc.adversarial.ATTACKS


# ---------------------------------------------------------------------------
# heads and registries
# ---------------------------------------------------------------------------

def test_head_registries_match_the_reference():
    assert tuple(decisions.PKT_HEADS) == tuple(jdec.PKT_HEADS)
    assert tuple(decisions.FLOW_HEADS) == tuple(jdec.FLOW_HEADS)
    assert decisions.packet_head("binary", deny_threshold=0.7) == decisions.BinaryHead(0.7)
    assert isinstance(decisions.packet_head("pass"), decisions.PassHead)
    assert isinstance(decisions.flow_head("class"), decisions.ClassHead)
    assert decisions.flow_head("anomaly", malicious_class=2).malicious_class == 2
    assert isinstance(decisions.flow_head("topk"), decisions.TopKHead)
    same_error(lambda: decisions.packet_head("topk"), lambda: jdec.packet_head("topk"))
    same_error(lambda: decisions.flow_head("binary"), lambda: jdec.flow_head("binary"))


def test_heads_satisfy_protocol_and_hash():
    heads = (decisions.BinaryHead(), decisions.PassHead(), decisions.ClassHead(),
             decisions.AnomalyHead(), decisions.TopKHead())
    theirs = (jdec.BinaryHead(), jdec.PassHead(), jdec.ClassHead(), jdec.AnomalyHead(),
              jdec.TopKHead())
    for head, ref in zip(heads, theirs):
        assert isinstance(head, decisions.DecisionHead)
        hash(head)  # frozen: usable as a config value
        assert (head.name, head.needs_logits) == (ref.name, ref.needs_logits)


@pytest.mark.parametrize("threshold,cls", [(0.5, 0), (0.3, 2), (0.02, 5)])
def test_anomaly_head_matches_the_reference(threshold, cls):
    rng = np.random.default_rng(cls)
    logits = rng.normal(0, 2, (64, 8)).astype(np.float32)
    logits[:4] = 0.0  # tied rows: the malicious probability exactly 1/8
    want = jdec.AnomalyHead(threshold, cls).decide(jnp.asarray(logits), None)
    got = decisions.AnomalyHead(threshold, cls).decide(torch.from_numpy(logits), None)
    np.testing.assert_array_equal(np.asarray(want[0]), got[0].numpy())
    np.testing.assert_array_equal(np.asarray(want[1]), got[1].numpy())
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5)
    assert got[0].dtype == got[1].dtype == torch.int32 and got[2].dtype == torch.float32


def test_anomaly_head_boundary_is_inclusive():
    logits = torch.tensor([[0.0, 0.0], [0.0, 4.0], [4.0, 0.0]])
    actions, cls, scores = decisions.AnomalyHead(0.5, 0).decide(logits, None)
    assert actions.tolist() == [DENY, MARK, DENY]
    assert float(scores[0]) == 0.5
    assert cls.tolist() == [0, 1, 0]


def test_pass_and_topk_heads_match_the_reference():
    n = 5
    batch = ft.PacketBatch(*(torch.arange(n, dtype=torch.int32) for _ in range(6)),
                           payload=torch.zeros((n, 4), dtype=torch.int32))
    got = decisions.PassHead().decide(None, batch)
    assert got.dtype == torch.int32 and got.tolist() == [0] * n
    feats = np.zeros((4, 16), np.int32)
    feats[:, HIST["flow_size"]] = [100, 7, 0, 9000]
    leaves = dict(slots=np.arange(4, dtype=np.int32), mask=np.ones(4, bool),
                  tuple_id=np.array([11, 22, 33, 44], np.int32), count=np.ones(4, np.int32),
                  features=feats, series=np.zeros((4, 6), np.int32),
                  sizes=np.zeros((4, 6), np.int32), payload=np.zeros((4, 4, 4), np.int32))
    want = jdec.TopKHead().decide(None, jft.DrainResult(**{k: jnp.asarray(v)
                                                           for k, v in leaves.items()}))
    got = decisions.TopKHead().decide(None, ft.DrainResult(**{k: torch.from_numpy(v)
                                                              for k, v in leaves.items()}))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert got[2].tolist() == [100, 7, 0, 9000] and got[1].tolist() == [-1] * 4


def test_feature_only_heads_run_no_engine(models):
    """A pipeline step under PassHead/TopKHead records no matmul (on the card
    it launches no engine kernel), and its outputs are the reference's."""
    shape = dict(batch_size=32, max_ready=8, table_size=64, top_n=6, top_k=4, pay_bytes=4)
    heads = dict(pkt_head=decisions.PassHead(), flow_head=decisions.TopKHead())
    pipe = OctopusPipeline(models["mlp"][1], models["cnn"][1], PipelineConfig(**shape, **heads),
                           device="cpu")
    jpipe = JOctopusPipeline(models["mlp"][0], models["cnn"][0], JPipelineConfig(
        **shape, pkt_head=jdec.PassHead(), flow_head=jdec.TopKHead()))
    tcfg = dict(batch_size=32, active_flows=8, table_size=64, pay_bytes=4, seed=3)
    gen = TrafficGenerator(TrafficConfig(**tcfg), device="cpu")
    jgen = jtraffic.TrafficGenerator(jtraffic.TrafficConfig(**tcfg))
    drained = 0
    for step in range(6):
        with record_routes() as routes:
            out = pipe.step(gen.next_batch())
        jout = jpipe.step(jgen.next_batch())
        assert routes == []
        for name in ("pkt_actions", "flow_actions", "flow_cls", "flow_scores"):
            np.testing.assert_array_equal(np.asarray(getattr(jout, name)),
                                          getattr(out, name).numpy(), err_msg=name)
        drained += int(out.drained.mask.sum())
    assert drained > 0
    assert pipe.rules.rules == jpipe.rules.rules
    assert "skipped (feature-only head)" in pipe.explain()


# ---------------------------------------------------------------------------
# attack traffic and merge_streams
# ---------------------------------------------------------------------------

ATTACK_TRAFFIC = {
    "flash_crowd": dict(batch_size=16, active_flows=24, table_size=256, adv_period=3,
                        collision_free=False),
    "flash_crowd_collision_free": dict(batch_size=16, active_flows=32, table_size=64,
                                       adv_period=2),
    "elephant_storm": dict(batch_size=32, active_flows=16, table_size=256, burst_len=8),
    "elephant_storm_colliding": dict(batch_size=24, active_flows=40, table_size=32,
                                     burst_len=4, collision_free=False),
    "collision_attack": dict(batch_size=16, active_flows=12, table_size=64, adv_slots=2,
                             collision_free=False, adv_shards=4),
}


@pytest.mark.parametrize("case", sorted(ATTACK_TRAFFIC))
def test_attack_traffic_matches_the_reference(case):
    mode = case.split("_colli")[0] if case != "collision_attack" else case
    cfg = dict(ATTACK_TRAFFIC[case], adversarial=mode, seed=9, pay_bytes=8)
    jgen = jtraffic.TrafficGenerator(jtraffic.TrafficConfig(**cfg))
    gen = TrafficGenerator(TrafficConfig(**cfg), device="cpu")
    for i in range(9):
        assert_batches_equal(jgen.next_batch(), gen.next_batch(), f"{case} batch {i}")
    for name in ("flows_started", "flows_completed", "batches_emitted", "clock"):
        assert getattr(gen, name) == getattr(jgen, name), name
    assert gen._live_hashes == jgen._live_hashes and gen._live_slots == jgen._live_slots


@pytest.mark.parametrize("kw", [
    dict(adversarial="slowloris"),
    dict(adversarial="flash_crowd", adv_period=0),
    dict(adversarial="collision_attack", collision_free=False, adv_slots=0),
    dict(adversarial="collision_attack", collision_free=False, table_size=16, adv_slots=17),
    dict(adversarial="collision_attack", collision_free=False, adv_shards=-1),
    dict(adversarial="collision_attack", collision_free=True),
], ids=["mode", "adv_period", "adv_slots_0", "adv_slots_past", "adv_shards", "collision_free"])
def test_traffic_config_refusals_match_the_reference(kw):
    same_error(lambda: TrafficConfig(**kw), lambda: jtraffic.TrafficConfig(**kw))


def test_flash_crowd_collision_free_needs_room():
    kw = dict(adversarial="flash_crowd", batch_size=32, active_flows=48, table_size=64,
              collision_free=True)
    same_error(lambda: TrafficGenerator(TrafficConfig(**kw), device="cpu"),
               lambda: jtraffic.TrafficGenerator(jtraffic.TrafficConfig(**kw)))
    TrafficGenerator(TrafficConfig(**dict(kw, batch_size=16, active_flows=32)), device="cpu")


def test_flash_crowd_and_elephant_storm_shapes():
    gen = TrafficGenerator(adversarial_config("flash_crowd", batch_size=16, adv_period=3,
                                              seed=2), device="cpu")
    for i, batch in enumerate(gen.batches(9), start=1):
        hashes = batch.tuple_hash.tolist()
        if i % 3 == 0:  # a crowd: all fresh one-packet flows, SYN-like
            assert len(set(hashes)) == 16 and (batch.flags == 2).all()
        else:
            assert len(set(hashes)) < 16
    storm = TrafficGenerator(adversarial_config("elephant_storm", batch_size=32, burst_len=8,
                                                seed=4), device="cpu")
    hashes = storm.next_batch().tuple_hash
    runs = torch.unique_consecutive(hashes, return_counts=True)[1]
    assert int(runs.max()) == 8 and runs.float().mean() > 2.0
    attack = TrafficGenerator(adversarial_config("collision_attack", batch_size=16,
                                                 adv_shards=4, seed=6), device="cpu")
    for batch in attack.batches(4):
        slots = ft.hash_slot(batch.tuple_hash, 64)
        assert int(slots.max()) < 2 and slots.unique().numel() < 16
        assert all(shard_of(h, 4) == 0 for h in batch.tuple_hash.tolist())


def _clients(modes, seed0: int):
    shaped = {"none": {}, "flash_crowd": dict(adv_period=2, collision_free=False),
              "elephant_storm": dict(burst_len=4),
              "collision_attack": dict(adv_slots=2, collision_free=False)}
    return [dict(batch_size=8, active_flows=8, table_size=64, adversarial=m, client_id=i,
                 seed=seed0 + i, **shaped[m]) for i, m in enumerate(modes)]


@pytest.mark.parametrize("modes", [("none", "none"),
                                   ("flash_crowd", "elephant_storm", "collision_attack")])
def test_merge_streams_matches_the_reference(modes):
    cfgs = _clients(modes, 10)
    want = list(jtraffic.merge_streams(*(jtraffic.TrafficGenerator(jtraffic.TrafficConfig(**c))
                                         for c in cfgs), seed=5, steps=18, tagged=True))
    got = list(merge_streams(*(TrafficGenerator(TrafficConfig(**c), device="cpu")
                               for c in cfgs), seed=5, steps=18, tagged=True))
    assert [c for c, _ in got] == [c for c, _ in want]
    for i, ((_, a), (_, b)) in enumerate(zip(want, got)):
        assert_batches_equal(a, b, f"merged batch {i}")
    bare = merge_streams(*(TrafficGenerator(TrafficConfig(**c), device="cpu") for c in cfgs),
                         seed=6, steps=18)
    assert [b.ts.tolist() for b in bare] != [b.ts.tolist() for _, b in got]
    same_error(lambda: next(merge_streams(seed=0, steps=1)),
               lambda: next(jtraffic.merge_streams(seed=0, steps=1)))


@settings(max_examples=15, deadline=None)
@given(num_clients=st.integers(1, 3), adversarial=st.booleans(),
       seed=st.integers(0, 2**16), steps=st.integers(1, 10))
def test_merge_streams_conserves_per_client_order(num_clients, adversarial, seed, steps):
    modes = (("flash_crowd", "elephant_storm", "collision_attack") if adversarial
             else ("none",) * 3)[:num_clients]
    cfgs = _clients(modes, 100)
    merged = list(merge_streams(*(TrafficGenerator(TrafficConfig(**c), device="cpu")
                                  for c in cfgs), seed=seed, steps=steps, tagged=True))
    assert len(merged) == steps
    per_client: dict[int, list] = {}
    for cid, batch in merged:
        per_client.setdefault(cid, []).append(batch)
    assert set(per_client) <= set(range(num_clients))
    for cid, got in per_client.items():
        alone = TrafficGenerator(TrafficConfig(**cfgs[cid]), device="cpu")
        for b in got:
            assert all(torch.equal(x, y) for x, y in zip(b, alone.next_batch()))


# ---------------------------------------------------------------------------
# heavy hitter
# ---------------------------------------------------------------------------

def test_top_k_flows_total_order():
    counters = {7: 100, 3: 100, 9: 50, 1: 200}
    assert top_k_flows(counters, 3) == [(1, 200), (3, 100), (7, 100)]
    assert top_k_flows(counters, 99) == jsc.top_k_flows(counters, 99)
    assert top_k_flows({}, 4) == []


@pytest.mark.parametrize("tracker", ["segmented", "scan"])
def test_heavy_hitter_with_cold_matches_the_reference(models, tracker):
    """Top-k and every resident counter equal the reference's every step,
    with a cold store small enough that spill and promote both fire."""
    shape = dict(k=6, batch_size=32, max_ready=4, table_size=32, cold_size=64, top_n=8,
                 top_k=4, pay_bytes=4, tracker=tracker)
    sc = HeavyHitterScenario(**shape, **weights(models, port=True), device="cpu")
    ref = jsc.HeavyHitterScenario(**shape, **weights(models, port=False))
    tcfg = dict(batch_size=32, active_flows=48, table_size=32, collision_free=False,
                pay_bytes=4, seed=3)
    gen = TrafficGenerator(TrafficConfig(**tcfg), device="cpu")
    jgen = jtraffic.TrafficGenerator(jtraffic.TrafficConfig(**tcfg))
    for step in range(14):
        sc.step(gen.next_batch())
        ref.step(jgen.next_batch())
        assert sc.counters() == ref.counters(), f"step {step}"
        assert sc.top_k() == ref.top_k(), f"step {step}"
    assert_states_equal(ref.pipe.state, sc.pipe.state, "state")
    assert sc.pipe.stats.spilled == ref.pipe.stats.spilled > 0
    assert sc.pipe.stats.promoted == ref.pipe.stats.promoted > 0


@pytest.mark.parametrize("num_shards,tracker", [(1, "segmented"), (2, "segmented"),
                                                (4, "segmented"), (4, "scan")])
def test_heavy_hitter_sharded_matches_the_reference(models, num_shards, tracker):
    """Sharded top-k under a collision attack pinned to lane 0, with cold
    lanes, against the reference's sharded scenario."""
    shape = dict(k=4, num_shards=num_shards, batch_size=16, max_ready=8, table_size=64,
                 cold_size=128, top_n=6, top_k=4, pay_bytes=4, tracker=tracker)
    sc = HeavyHitterScenario(**shape, **weights(models, port=True), device="cpu")
    ref = jsc.HeavyHitterScenario(**shape, **weights(models, port=False))
    attack = dict(batch_size=16, table_size=64, active_flows=10, adv_slots=2,
                  adv_shards=num_shards, pay_bytes=4, seed=5)
    gen = TrafficGenerator(adversarial_config("collision_attack", **attack), device="cpu")
    jgen = jtraffic.TrafficGenerator(jsc.adversarial_config("collision_attack", **attack))
    for step in range(10):
        sc.step(gen.next_batch())
        ref.step(jgen.next_batch())
        assert sc.top_k() == ref.top_k(), f"step {step}"
    assert sc.counters() == ref.counters()
    assert_states_equal(ref.pipe.state, sc.pipe.state, "state")
    assert sc.pipe.stats.packets == 10 * 16


def test_heavy_hitter_run_snapshots_and_refusals():
    sc = HeavyHitterScenario(k=3, batch_size=16, max_ready=4, table_size=32, top_n=8, top_k=4,
                             pay_bytes=4, device="cpu")
    gen = TrafficGenerator(TrafficConfig(batch_size=16, active_flows=8, table_size=32,
                                         pay_bytes=4, seed=1), device="cpu")
    snaps = sc.run(gen, 5)
    assert len(snaps) == 5 and all(len(s) <= 3 for s in snaps)
    assert snaps[-1] == sc.top_k() and snaps[-1]
    same_error(lambda: HeavyHitterScenario(k=0, device="cpu"),
               lambda: jsc.HeavyHitterScenario(k=0))
    same_error(lambda: HeavyHitterScenario(k=2, flow_head=None, device="cpu"),
               lambda: jsc.HeavyHitterScenario(k=2, flow_head=None))


# ---------------------------------------------------------------------------
# DDoS
# ---------------------------------------------------------------------------

DDOS_TRAFFIC = dict(batch_size=32, active_flows=8, table_size=256, elephant_fraction=1.0,
                    elephant_pkts=(30, 60), seed=7)


def ddos_traffic(port: bool):
    if port:
        return TrafficGenerator(TrafficConfig(**DDOS_TRAFFIC), device="cpu")
    return jtraffic.TrafficGenerator(jtraffic.TrafficConfig(**DDOS_TRAFFIC))


@pytest.fixture(scope="module")
def ddos_band(models):
    """The reference test's calibration: a probe with the band parked at the
    extremes, the band from its score quantiles; the reference's probe
    emissions and band, and the port's probe."""
    ref = jsc.DDoSScenario(deny_on=0.99, deny_off=0.0, **weights(models, port=False))
    ref.run(ddos_traffic(False), 20)
    probe = DDoSScenario(deny_on=0.99, deny_off=0.0, **weights(models, port=True),
                         device="cpu")
    probe.run(ddos_traffic(True), 20)
    scores = np.array([s for _, s in ref.emissions])
    on, off = np.quantile(scores, [0.6, 0.4])
    assert scores.size >= 8 and off < on
    return float(on), float(off), ref.emissions, probe.emissions


def assert_emissions_equal(want, got) -> None:
    assert [f for f, _ in got] == [f for f, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=1e-5)


def test_ddos_probe_emissions_match_the_reference(ddos_band):
    _, _, want, got = ddos_band
    assert_emissions_equal(want, got)


@pytest.mark.parametrize("kw", [{}, dict(scan_len=4), dict(num_shards=2)],
                         ids=["step", "scan_len_4", "sharded"])
def test_ddos_matches_the_reference(models, ddos_band, kw):
    """Denied set, churn, emissions and rule table equal the reference's;
    after every dispatch each denied flow reads deny in the rule table."""
    on, off, probe, _ = ddos_band
    sc = DDoSScenario(deny_on=on, deny_off=off, **kw, **weights(models, port=True),
                      device="cpu")
    ref = jsc.DDoSScenario(deny_on=on, deny_off=off, **kw, **weights(models, port=False))
    gen, jgen = ddos_traffic(True), ddos_traffic(False)
    dispatch = kw.get("scan_len", 1)
    for _ in range(20 // dispatch):
        sc.run(gen, dispatch)
        ref.run(jgen, dispatch)
        assert sc.denied == ref.denied
        for fid in sc.denied:
            assert sc.pipe.rules.lookup(fid)["action"] == "deny"
    assert_emissions_equal(ref.emissions, sc.emissions)
    if "num_shards" not in kw:  # the lanes drain in another order
        assert_emissions_equal(probe, sc.emissions)
    assert (sc.churn, sc.churn_raw) == (ref.churn, ref.churn_raw)
    assert sc.churn <= sc.churn_raw
    assert len(sc.denied) >= 1 and len({f for f, _ in sc.emissions}) > len(sc.denied)
    assert sc.pipe.rules.rules == ref.pipe.rules.rules
    assert sc.pipe.stats.packets == ref.pipe.stats.packets == 20 * 32
    replay = HysteresisController(on, off)
    for fid, s in sc.emissions:
        replay.observe(fid, s)
    assert (replay.denied, replay.churn, replay.churn_raw) == (sc.denied, sc.churn,
                                                               sc.churn_raw)


def test_ddos_refusals_match_the_reference():
    same_error(lambda: DDoSScenario(deny_on=0.5, deny_off=0.5, device="cpu"),
               lambda: jsc.DDoSScenario(deny_on=0.5, deny_off=0.5))
    same_error(lambda: HysteresisController(0.4, 0.6), lambda: jsc.HysteresisController(0.4, 0.6))
    same_error(lambda: DDoSScenario(flow_head=None, device="cpu"),
               lambda: jsc.DDoSScenario(flow_head=None))


@settings(max_examples=60, deadline=None)
@given(events=st.lists(st.tuples(st.integers(0, 5), st.floats(0.0, 1.0)), max_size=80),
       t0=st.floats(0.0, 1.0), t1=st.floats(0.0, 1.0))
def test_hysteresis_churn_never_exceeds_raw(events, t0, t1):
    off, on = sorted((t0, t1))
    if not off < on:
        return  # the controller needs a strict band
    ctl = HysteresisController(on, off)
    for fid, s in events:
        ctl.observe(fid, s)
    assert ctl.churn <= ctl.churn_raw
    assert ctl.denied <= {f for f, s in events if s >= on}


@settings(max_examples=40, deadline=None)
@given(scores=st.lists(st.floats(0.0, 1.0), max_size=60))
def test_hysteresis_single_flow_writes_bounded(scores):
    ctl, ref = HysteresisController(0.7, 0.3), jsc.HysteresisController(0.7, 0.3)
    for s in scores:
        ctl.observe(0, s)
        ref.observe(0, s)
    assert ctl.churn <= ctl.churn_raw and ctl.churn <= len(scores)
    assert (0 in ctl.denied) == (ctl.churn % 2 == 1)
    assert (ctl.denied, ctl.churn, ctl.churn_raw) == (ref.denied, ref.churn, ref.churn_raw)


# ---------------------------------------------------------------------------
# adversarial
# ---------------------------------------------------------------------------

ADV_SHAPE = dict(batch_size=16, max_ready=4, table_size=64, top_n=6, top_k=4, pay_bytes=4)


@pytest.mark.parametrize("mode", ["flash_crowd", "elephant_storm", "collision_attack"])
def test_adversarial_scenario_matches_the_reference(models, mode):
    """Every mode through the pipeline: each packet ingested once, the state,
    counters and rule table equal the reference's."""
    pipe = OctopusPipeline(models["mlp"][1], models["cnn"][1],
                           PipelineConfig(**ADV_SHAPE, flow_head=decisions.TopKHead()),
                           device="cpu")
    jpipe = JOctopusPipeline(models["mlp"][0], models["cnn"][0],
                             JPipelineConfig(**ADV_SHAPE, flow_head=jdec.TopKHead()))
    tcfg = dict(batch_size=16, table_size=64, pay_bytes=4, seed=8)
    sc = AdversarialScenario(pipe, adversarial_config(mode, **tcfg))
    ref = jsc.AdversarialScenario(jpipe, jsc.adversarial_config(mode, **tcfg))
    assert sc.mode == mode and sc.gen.device == pipe.device
    stats, jstats = sc.run(8), ref.run(8)
    assert stats.packets == 8 * 16 and stats.new_flows > 0
    for name in ("packets", "flows", "new_flows", "evicted"):
        assert getattr(stats, name) == getattr(jstats, name), name
    assert_states_equal(jpipe.state, pipe.state, "state")
    assert pipe.rules.rules == jpipe.rules.rules


@pytest.mark.parametrize("tracker", ["segmented", "scan"])
def test_collision_attack_bit_exact_against_the_reference(models, tracker):
    """The attack takes the segmented tracker's collision fallback every
    batch; state and drained rows stay bit for bit the reference's, and the
    two trackers agree."""
    cfg = dict(batch_size=16, max_ready=4, table_size=16, top_n=6, top_k=4, pay_bytes=4,
               tracker=tracker)
    pipe = OctopusPipeline(models["mlp"][1], models["cnn"][1],
                           PipelineConfig(**cfg, flow_head=decisions.TopKHead()), device="cpu")
    jpipe = JOctopusPipeline(models["mlp"][0], models["cnn"][0],
                             JPipelineConfig(**cfg, flow_head=jdec.TopKHead()))
    attack = dict(batch_size=16, table_size=16, adv_slots=2, active_flows=8, pay_bytes=4,
                  seed=11)
    gen = TrafficGenerator(adversarial_config("collision_attack", **attack), device="cpu")
    jgen = jtraffic.TrafficGenerator(jsc.adversarial_config("collision_attack", **attack))
    for step in range(8):
        out, jout = pipe.step(gen.next_batch()), jpipe.step(jgen.next_batch())
        assert_states_equal(jpipe.state, pipe.state, f"step {step} state")
        assert_states_equal(jout.drained, out.drained, f"step {step} drained")
        np.testing.assert_array_equal(np.asarray(jout.pkt_actions), out.pkt_actions.numpy())
        if tracker == "segmented":
            assert int(out.fallback_slots) > 0
    assert pipe.stats.evicted == jpipe.stats.evicted > 0


def test_adversarial_refusals_match_the_reference(models):
    pipe = OctopusPipeline(models["mlp"][1], models["cnn"][1],
                           PipelineConfig(**ADV_SHAPE, flow_head=decisions.TopKHead()),
                           device="cpu")
    same_error(lambda: AdversarialScenario(pipe, TrafficConfig(batch_size=16)),
               lambda: jsc.AdversarialScenario(None, jtraffic.TrafficConfig(batch_size=16)))
    same_error(lambda: adversarial_config("none"), lambda: jsc.adversarial_config("none"))
    gen = TrafficGenerator(adversarial_config("elephant_storm", batch_size=16), device="cpu")
    assert AdversarialScenario(pipe, gen).gen is gen
