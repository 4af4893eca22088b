"""The port's two-level flow table (``repro_torch.core.cold_store``, the spill
records of both trackers, and the pipeline's ``cold_size``/``cold_policy``)
against the JAX package, bit for bit: the hash mixers, each step of the
two-level merge (promote, merge with spills, apply spills, scrub) on a
collision storm whose records share cold slots and whose tuples spill
several times a batch, and the whole pipeline under both trackers and both
policies.  The cold leaves must be written in place, never copied.

Inputs are seeded with numpy (the storm, built as the reference's
``tests/test_cold_store.py`` builds its spill-record test) or come from the
reference's traffic generator; the JAX side runs without ``use_pallas``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cold_store as jcs
from repro.core import feature_extractor as jfx
from repro.core import flow_tracker as jft
from repro.data.traffic import TrafficConfig as JTrafficConfig
from repro.data.traffic import TrafficGenerator as JTrafficGenerator
from repro.kernels.flow_features.ops import default_program as j_default_program
from repro.models import paper_models as jpm
from repro.runtime import RuntimeConfig as JRuntimeConfig
from repro.serving import OctopusPipeline as JOctopusPipeline
from repro.serving import PipelineConfig as JPipelineConfig
from repro_torch import convert
from repro_torch.core import cold_store as cs
from repro_torch.core import feature_extractor as fx
from repro_torch.core import flow_tracker as ft
from repro_torch.data.traffic import TrafficConfig, TrafficGenerator
from repro_torch.kernels.flow_features.ops import default_program, flow_feature_update
from repro_torch.serving import OctopusPipeline, PipelineConfig


j_promote = jax.jit(jcs.promote_pass, static_argnames=("policy",))
j_apply = jax.jit(jcs.apply_spills, static_argnames=("policy",))
j_scrub = jax.jit(jcs.scrub_live)
j_segmented = jax.jit(jfx.segmented_update, static_argnames=("top_n", "with_spills"))
j_process = jax.jit(jft.process_packets, static_argnames=("top_n", "with_spills"))


def assert_tuple_equal(want, got, what: str):
    for name, a, b in zip(want._fields, want, convert.to_numpy(got)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=f"{what}.{name}")


def params(kind: str, seed: int):
    jp = jpm.init_paper_model(kind, jax.random.PRNGKey(seed))
    return jp, convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                         device="cpu")


@pytest.fixture(scope="module")
def models():
    return params("mlp", 0), params("transformer", 2)


def test_cold_slots_match_reference():
    rng = np.random.default_rng(0)
    hashes = np.concatenate([rng.integers(-2**31, 2**31, 2048),
                             [0, 1, -1, 2**31 - 1, -2**31, 0x7FFF0000]]).astype(np.int32)
    for size in (2, 13, 64, 1 << 17, 1 << 20):
        want = [np.asarray(x) for x in jcs.cold_slots(jnp.asarray(hashes), size)]
        got = [x.numpy() for x in cs.cold_slots(torch.as_tensor(hashes), size)]
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == np.int32
        assert [cs.cold_slots_scalar(int(h), size) for h in hashes[:64]] == [
            jcs.cold_slots_scalar(int(h), size) for h in hashes[:64]]


def test_rounds_order_records_that_share_a_slot():
    """Each record waits for every earlier pending record on one of its
    slots, and a round's records share none."""
    touch = torch.tensor([[0, 1], [2, 3], [1, 4], [4, 5], [6, 6], [0, 7], [8, 9]])
    active = torch.tensor([True, True, True, True, True, True, False])
    rounds = [sel.tolist() for sel in cs._rounds(touch, active)]
    assert rounds == [[0, 1, 4], [2, 5], [3]]
    assert list(cs._rounds(touch, torch.zeros(7, dtype=torch.bool))) == []


def storm(seed: int, rounds: int, *, table: int, pay: int, p: int = 32, pool: int = 40):
    """Batches drawn from a small pool of tuples (the reference's spill-record
    test): many evictions, tuples that spill twice in a batch; every third
    batch keep-masked."""
    rng = np.random.default_rng(seed)
    tuples = rng.integers(1, 10_000, size=pool)
    clock = 0
    for rnd in range(rounds):
        ts = clock + np.cumsum(rng.integers(1, 30, size=p))
        clock = int(ts[-1])
        leaves = [ts, rng.integers(40, 1500, p), rng.integers(0, 2, p), rng.integers(0, 64, p),
                  rng.integers(0, 3, p), rng.choice(tuples, size=p), rng.integers(0, 256, (p, pay))]
        leaves = [np.asarray(a, np.int32) for a in leaves]
        keep = rng.random(p) < 0.7 if rnd % 3 == 2 else None
        yield leaves, keep


@pytest.mark.parametrize("tracker", ["segmented", "scan"])
@pytest.mark.parametrize("policy", ["age", "lru"])
def test_two_level_step_matches_reference(policy, tracker):
    """Promote, merge with spill records, apply spills, scrub: each stage's
    hot and cold leaves (stamps and tick), spill records and counts equal the
    reference's, batch after batch, on a cold table of 13 slots, where
    records share candidates and a tuple spills several times a batch."""
    F, C, TOP_N, TOP_K, PAY = 16, 13, 4, 3, 4
    js = jcs.init_two_level(F, C, TOP_N, TOP_K, PAY)
    ps = cs.init_two_level(F, C, TOP_N, TOP_K, PAY, device="cpu")
    program = default_program("cpu")
    spilled = promoted = repeats = shared = 0
    for rnd, (leaves, keep) in enumerate(storm(7, 12, table=F, pay=PAY)):
        jb = jft.PacketBatch(*(jnp.asarray(a) for a in leaves))
        pb = convert.packet_batch_from_numpy(leaves, device="cpu")
        jk = None if keep is None else jnp.asarray(keep)
        pk = None if keep is None else torch.as_tensor(keep)
        jh, jc, jn = j_promote(js.hot, js.cold, jb, jk, policy=policy)
        ph, pc, pn = cs.promote_pass(ps.hot, ps.cold, pb, pk, policy=policy)
        assert_tuple_equal(jh, ph, f"batch {rnd} promote hot")
        assert_tuple_equal(jc, pc, f"batch {rnd} promote cold")
        assert int(jn) == int(pn)
        promoted += int(pn)
        if tracker == "segmented":
            jh, jo, jsp = j_segmented(jh, jb, top_n=TOP_N, keep=jk, with_spills=True)
            ph, po, psp = fx.segmented_update(ph, pb, top_n=TOP_N, keep=pk, with_spills=True)
        else:
            jh, jo, jsp = j_process(jh, jb, j_default_program(), top_n=TOP_N,
                                              keep=jk, with_spills=True)
            ph, po, psp = ft.process_packets(ph, pb, program, top_n=TOP_N, keep=pk,
                                             with_spills=True)
        assert_tuple_equal(jh, ph, f"batch {rnd} merge")
        assert_tuple_equal(jsp, psp, f"batch {rnd} SpillRecords")
        jc, jn = j_apply(jc, jsp, policy=policy)
        pc, pn = cs.apply_spills(pc, psp, policy=policy)
        assert_tuple_equal(jc, pc, f"batch {rnd} apply_spills")
        assert int(jn) == int(pn)
        spilled += int(pn)
        m = psp.mask.numpy()
        tids = psp.tuple_id.numpy()[m]
        repeats += len(tids) - len(set(tids.tolist()))
        cand = np.concatenate([x.numpy()[m] for x in cs.cold_slots(psp.tuple_id, C)])
        shared += len(cand) - len(set(cand.tolist()))
        jc = j_scrub(jc, jh, jb, jk)
        pc = cs.scrub_live(pc, ph, pb, pk)
        assert_tuple_equal(jc, pc, f"batch {rnd} scrub_live")
        js, ps = jcs.TwoLevelState(jh, jc), cs.TwoLevelState(ph, pc)
    assert int(cs.cold_occupancy(ps.cold)) == int(jcs.cold_occupancy(js.cold)) > 0
    assert spilled > 100 and promoted > 20
    assert repeats > 0 and shared > 0  # the ordered part of the walks ran


@pytest.mark.parametrize("policy,evicted_slot", [("age", 1), ("lru", 0)])
def test_insert_policy_matches_reference(policy, evicted_slot):
    """A full two-slot table takes a third tuple: age evicts the older
    last_ts, lru the earlier insert; a tuple's second spill overwrites its
    own entry."""
    def find(want, start=1):
        return next(h for h in range(start, 10**7) if jcs.cold_slots_scalar(h, 2) == want)

    h1 = find((0, 1))
    h2 = find((1, 0), h1 + 1)
    h3 = find((0, 1), h2 + 1)
    rows = [(h1, 3, 100), (h2, 4, 50), (h3, 5, 200), (h3, 6, 210)]
    p = len(rows)
    leaves = [np.ones(p, bool), np.zeros(p, np.int32), np.array([r[0] for r in rows], np.int32),
              np.array([r[1] for r in rows], np.int32), np.array([r[2] for r in rows], np.int32),
              np.arange(p * 16, dtype=np.int32).reshape(p, 16), np.zeros((p, 2), np.int32),
              np.ones((p, 2), np.int32), np.full((p, 2, 2), 7, np.int32)]
    jc, jn = jcs.apply_spills(jcs.init_cold(2, 2, 2, 2), jft.SpillRecords(*map(jnp.asarray, leaves)),
                              policy=policy)
    pc, pn = cs.apply_spills(cs.init_cold(2, 2, 2, 2, device="cpu"),
                             ft.SpillRecords(*map(torch.as_tensor, leaves)), policy=policy)
    assert_tuple_equal(jc, pc, "cold")
    assert int(pn) == 4 and int(pc.tuple_id[evicted_slot]) == h3 and int(pc.count.max()) == 6


def test_segmented_update_leaves_its_input_and_spills_pre_batch_rows():
    """The records read the input table after the fold: the fold must leave
    it as it was (``flow_update`` writes a new table), so every spilled row
    equals the occupant's pre-batch row."""
    F, TOP_N = 16, 4
    state = ft.init_state(F, TOP_N, 3, 4, device="cpu")
    checked = 0
    for rnd, (leaves, keep) in enumerate(storm(3, 6, table=F, pay=4)):
        batch = convert.packet_batch_from_numpy(leaves, device="cpu")
        before = ft.TrackerState(*(leaf.clone() for leaf in state))
        nxt, _, spills = fx.segmented_update(state, batch, top_n=TOP_N, with_spills=True)
        assert_tuple_equal(before, state, f"batch {rnd} input state")
        slots = ft.hash_slot(batch.tuple_hash, F).tolist()
        first = {}
        for pos, slot in enumerate(slots):
            first.setdefault(slot, pos)
        # an eviction at a slot's first packet spills the pre-batch occupant
        heads = [pos for pos in spills.mask.nonzero().flatten().tolist()
                 if first[slots[pos]] == pos]
        checked += len(heads)
        for name in ft.TrackerState._fields:
            got = getattr(spills, name)[heads]
            want = getattr(before, name)[[slots[pos] for pos in heads]]
            assert torch.equal(got, want), name
        state = nxt
    assert checked > 20
    table = torch.randint(-99, 99, (F, 16), dtype=torch.int32)
    kept = table.clone()
    slots = torch.randint(0, F, (64,), dtype=torch.int32)
    meta = torch.randint(0, 500, (64, 13), dtype=torch.int32)
    out = flow_feature_update(default_program("cpu"), slots, meta, table)
    assert torch.equal(table, kept) and out.data_ptr() != table.data_ptr()


def two_level_cfgs(tracker, policy):
    shape = dict(batch_size=24, max_ready=6, flow_model="transformer", table_size=16,
                 top_n=6, top_k=15, pay_bytes=16, tracker=tracker, cold_size=64,
                 cold_policy=policy)
    return JPipelineConfig(**shape), PipelineConfig(**shape)


STORM = dict(batch_size=24, active_flows=48, elephant_fraction=0.5, table_size=16, seed=13,
             burst_prob=0.3, collision_free=False)


@pytest.mark.parametrize("tracker", ["segmented", "scan"])
@pytest.mark.parametrize("policy", ["age", "lru"])
def test_two_level_pipeline_matches_reference(models, tracker, policy):
    """The pipeline with a cold table against the reference's on a
    collision storm of 3x the hot table: every step's drained rows, spill
    and promote counts, hot and cold leaves; then the rule tables."""
    (jmlp, mlp), (jtf, tf) = models
    jcfg, cfg = two_level_cfgs(tracker, policy)
    jpipe = JOctopusPipeline(jmlp, jtf, jcfg, config=JRuntimeConfig(use_pallas=False))
    pipe = OctopusPipeline(mlp, tf, cfg, device="cpu")
    jgen = JTrafficGenerator(JTrafficConfig(**STORM))
    gen = TrafficGenerator(TrafficConfig(**STORM), device="cpu")
    for step in range(20):
        jout = jpipe.step(jgen.next_batch())
        out = pipe.step(gen.next_batch())
        assert_tuple_equal(jout.drained, out.drained, f"step {step} DrainResult")
        for name in ("pkt_actions", "flow_cls", "new_flows", "evicted", "spilled", "promoted"):
            np.testing.assert_array_equal(np.asarray(getattr(jout, name)),
                                          getattr(out, name).numpy(), err_msg=name)
        assert_tuple_equal(jpipe.state.hot, pipe.state.hot, f"step {step} hot")
        assert_tuple_equal(jpipe.state.cold, pipe.state.cold, f"step {step} cold")
    assert pipe.rules.rules == jpipe.rules.rules
    s, js = pipe.stats, jpipe.stats
    assert (s.spilled, s.promoted, s.flows) == (js.spilled, js.promoted, js.flows)
    assert s.spilled > 50 and s.promoted > 50 and s.flows > 0


def test_port_continues_from_the_reference_two_level_state(models):
    """The reference's hot and cold banks after 10 storm steps, carried
    across through numpy, step on in the port as in the reference."""
    (jmlp, mlp), (jtf, tf) = models
    jcfg, cfg = two_level_cfgs("segmented", "lru")
    jpipe = JOctopusPipeline(jmlp, jtf, jcfg, config=JRuntimeConfig(use_pallas=False))
    jgen = JTrafficGenerator(JTrafficConfig(**STORM))
    for _ in range(10):
        jpipe.step(jgen.next_batch())
    pipe = OctopusPipeline(mlp, tf, cfg, device="cpu")
    pipe.state = convert.two_level_state_from_numpy(
        [np.asarray(x) for x in jpipe.state.hot], [np.asarray(x) for x in jpipe.state.cold],
        device="cpu")
    assert int(pipe.state.cold.tick) == int(jpipe.state.cold.tick) > 0
    for step in range(8):
        batch = jgen.next_batch()
        jout = jpipe.step(batch)
        out = pipe.step(convert.packet_batch_from_numpy([np.asarray(a) for a in batch],
                                                         device="cpu"))
        assert_tuple_equal(jout.drained, out.drained, f"step {step} DrainResult")
        assert (int(out.spilled), int(out.promoted)) == (int(jout.spilled), int(jout.promoted))
    assert_tuple_equal(jpipe.state.hot, pipe.state.hot, "hot")
    assert_tuple_equal(jpipe.state.cold, pipe.state.cold, "cold")


def test_cold_leaves_are_written_in_place(models):
    """No step copies the cold bank: each cold leaf keeps its storage while
    flows spill and promote; ``reset`` and ``warmup`` leave the live table."""
    (_, mlp), (_, tf) = models
    _, cfg = two_level_cfgs("segmented", "lru")
    pipe = OctopusPipeline(mlp, tf, cfg, device="cpu")
    ptrs = [leaf.data_ptr() for leaf in pipe.state.cold]
    pipe.warmup()
    gen = TrafficGenerator(TrafficConfig(**STORM), device="cpu")
    pipe.run(gen, steps=8)
    assert [leaf.data_ptr() for leaf in pipe.state.cold] == ptrs
    assert pipe.stats.spilled > 0 and pipe.stats.promoted > 0
    assert int(pipe.state.cold.tick) >= pipe.stats.spilled  # spills + displaced occupants
    pipe.reset()
    assert int(cs.cold_occupancy(pipe.state.cold)) == 0 and pipe.stats.steps == 0


def test_cold_attached_is_hot_only_on_collision_free_traffic(models):
    """With no eviction the cold table stays empty and the hot path is the
    hot-only pipeline's, step for step; the state types and the explain
    line name the mode."""
    (_, mlp), (_, tf) = models
    shape = dict(batch_size=24, max_ready=4, flow_model="transformer", table_size=64, top_n=6)
    base = OctopusPipeline(mlp, tf, PipelineConfig(**shape), device="cpu")
    two = OctopusPipeline(mlp, tf, PipelineConfig(**shape, cold_size=512, cold_policy="lru"),
                          device="cpu")
    assert isinstance(base.state, ft.TrackerState) and "cold" not in base.explain()
    assert isinstance(two.state, cs.TwoLevelState) and "cold=512(lru)" in two.explain()
    tcfg = dict(batch_size=24, active_flows=16, elephant_fraction=0.5, table_size=64, seed=11)
    g0 = TrafficGenerator(TrafficConfig(**tcfg), device="cpu")
    g1 = TrafficGenerator(TrafficConfig(**tcfg), device="cpu")
    for _ in range(12):
        a, b = base.step(g0.next_batch()), two.step(g1.next_batch())
        assert_tuple_equal(a.drained, b.drained, "drained")
        assert torch.equal(a.pkt_actions, b.pkt_actions)
    assert_tuple_equal(base.state, two.state.hot, "hot")
    assert two.stats.spilled == two.stats.promoted == 0
    assert int(cs.cold_occupancy(two.state.cold)) == 0
