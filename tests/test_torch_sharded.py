"""The port's ``ShardedOctopusPipeline`` (one lane-batched bank) against the
JAX package's sharded pipeline on its ``vmap`` backend, at the reference
test's small config (batch 24, table 64, transformer flow model): the hash
partition, every step's verdicts, drained rows and counters, the (S, F, ...)
state (and the (S, C, ...) cold lanes with their (S,) clocks), the rule
table and the stats counters bit for bit; flow scores within rtol 1e-5;
``explain()`` text and the constructor's errors.  Then the port's lanes
against its own single lane where the reference's exactness preconditions
hold (collision-free traffic, no lane backlog).  The shard_map lanes (one
device a lane, ``devices=["cpu"] * S``) run one case against the
reference's vmap backend (its own tests hold its vmap equal to its
shard_map), and every other case's config against the port's vmap lanes
on the same stream.

The JAX pipelines run without ``use_pallas``; traffic comes from each
package's own generator (the port's draws the reference's packets).  The
reference runs are shared through one module-scoped cache."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flow_tracker as jft
from repro.data.traffic import TrafficConfig as JTrafficConfig
from repro.data.traffic import TrafficGenerator as JTrafficGenerator
from repro.data.traffic import partition_batch as j_partition_batch
from repro.data.traffic import shard_of as j_shard_of
from repro.models import paper_models as jpm
from repro.runtime import RuntimeConfig as JRuntimeConfig
from repro.serving import PipelineConfig as JPipelineConfig
from repro.serving import ShardedOctopusPipeline as JShardedOctopusPipeline
from repro_torch import convert
from repro_torch.core import flow_tracker as ft
from repro_torch.data.traffic import (
    TrafficConfig,
    TrafficGenerator,
    lane_rounds,
    partition_batch,
    shard_of,
)
from repro_torch.serving import (
    OctopusPipeline,
    PipelineConfig,
    ShardedOctopusPipeline,
)
from repro_torch.serving.pipeline import InflightDispatch

SHAPE = dict(batch_size=24, max_ready=16, flow_model="transformer", table_size=64, top_n=6,
             top_k=15, pay_bytes=16)
TRAFFIC = dict(batch_size=24, active_flows=12, elephant_fraction=0.5, table_size=64, seed=7,
               burst_prob=0.3)
# colliding traffic for the two-level table: 160 live flows on 64 slots a lane
SPILL = dict(TRAFFIC, active_flows=160, collision_free=False)
# every flow on 4 hot slots and in lane 0 of 4: lane 0 takes the whole batch
ATTACK = dict(TRAFFIC, active_flows=16, collision_free=False, adversarial="collision_attack",
              adv_slots=4, adv_shards=4)
COUNTS = ("packets", "steps", "flows", "new_flows", "evicted", "spilled", "promoted",
          "dispatches", "padded")
STEPS = 12

# name -> (num_shards, pipeline overrides, sharded kwargs, traffic, mode)
CASES = {
    "s1": (1, {}, {}, TRAFFIC, "step"),
    "s2": (2, {}, {}, TRAFFIC, "step"),
    "s4": (4, {}, {}, TRAFFIC, "step"),
    "s2_scan": (2, dict(tracker="scan"), {}, TRAFFIC, "step"),
    "s4_rounds": (4, {}, dict(lane_batch=8), TRAFFIC, "step"),
    "s2_chunks": (2, dict(scan_len=4), {}, TRAFFIC, "chunks"),
    "s2_overlap": (2, dict(overlap=True), {}, TRAFFIC, "overlap"),
    "s2_masked": (2, {}, {}, TRAFFIC, "masked"),
    "s2_cold_age": (2, dict(cold_size=32), {}, SPILL, "step"),
    "s4_cold_lru_rounds": (4, dict(cold_size=32, cold_policy="lru"), dict(lane_batch=8),
                           SPILL, "step"),
    "s4_attack": (4, {}, dict(lane_batch=6), ATTACK, "step"),
    # the shard_map lanes: a device a lane, each lane's step unbatched
    "s2_shard_map": (2, {}, dict(backend="shard_map"), TRAFFIC, "step"),
}


@pytest.fixture(scope="module")
def models():
    out = {}
    for kind, seed in (("mlp", 0), ("cnn", 1), ("transformer", 2)):
        jp = jpm.init_paper_model(kind, jax.random.PRNGKey(seed))
        out[kind] = (jp, convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                                   device="cpu"))
    return out


def to_np(tree):
    """Leaves of a (nested) NamedTuple of tensors or JAX arrays, as numpy."""
    out = []
    for leaf in tree:
        if isinstance(leaf, tuple):
            out.extend(to_np(leaf))
        else:
            out.append(leaf.numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf))
    return out


def to_tensors(tree):
    """Leaves of a (nested) NamedTuple of tensors."""
    return [x for leaf in tree for x in (to_tensors(leaf) if isinstance(leaf, tuple) else [leaf])]


def assert_outputs_equal(jout, out, what: str):
    for name in ("pkt_actions", "flow_actions", "flow_cls", "new_flows", "evicted", "spilled",
                 "promoted"):
        np.testing.assert_array_equal(np.asarray(getattr(jout, name)),
                                      getattr(out, name).numpy(), err_msg=f"{what} {name}")
    for name, a, b in zip(ft.DrainResult._fields, to_np(jout.drained), to_np(out.drained)):
        np.testing.assert_array_equal(a, b, err_msg=f"{what} drained.{name}")
    np.testing.assert_allclose(np.asarray(jout.flow_scores), out.flow_scores.numpy(),
                               rtol=1e-5, atol=1e-6, err_msg=f"{what} flow_scores")


def pad(batch, bucket: int, keep: np.ndarray):
    """``batch`` scattered into a ``bucket``-row batch at the rows ``keep``
    marks (zeros elsewhere), as numpy leaves."""
    out = []
    for leaf in batch:
        a = np.asarray(leaf)
        full = np.zeros((bucket, *a.shape[1:]), a.dtype)
        full[keep] = a
        out.append(full)
    return out


def step_of(out, j: int):
    """Step ``j`` of a chunk's stacked output."""
    return type(out)(*(type(x)(*(y[j] for y in x)) if isinstance(x, tuple) else x[j]
                       for x in out))


def drive(models, name: str):
    """Run one case through the reference and the port, holding every step
    equal; returns ``(ref, port, port outputs a step)``."""
    S, over, sh_kw, traffic, mode = CASES[name]
    cfg = dict(SHAPE, **over)
    (jmlp, mlp), (jtf, tf) = models["mlp"], models["transformer"]
    ref_kw = {k: v for k, v in sh_kw.items() if k != "backend"}  # the reference's vmap
    port_kw = dict(sh_kw, devices=["cpu"] * S) if sh_kw.get("backend") == "shard_map" else sh_kw
    ref = JShardedOctopusPipeline(jmlp, jtf, JPipelineConfig(**cfg), num_shards=S,
                                  config=JRuntimeConfig(use_pallas=False), **ref_kw)
    port = ShardedOctopusPipeline(mlp, tf, PipelineConfig(**cfg), num_shards=S, device="cpu",
                                  **port_kw)
    jgen = JTrafficGenerator(JTrafficConfig(**traffic))
    gen = TrafficGenerator(TrafficConfig(**traffic), device="cpu")
    outs = []
    if mode == "chunks":
        L = cfg["scan_len"]
        for k in range(STEPS // L):
            jout = ref.step_many([jgen.next_batch() for _ in range(L)])
            out = port.step_many([gen.next_batch() for _ in range(L)])
            for j in range(L):
                assert_outputs_equal(step_of(jout, j), step_of(out, j), f"{name} chunk {k}")
                outs.append(step_of(out, j))
    elif mode == "masked":
        rng = np.random.default_rng(3)
        for bucket in (32, 48):
            ref.warm_bucket(bucket)
            port.warm_bucket(bucket)
        for step in range(STEPS):
            bucket = (32, 48)[step % 2]
            keep = np.zeros(bucket, bool)
            keep[np.sort(rng.choice(bucket, 24, replace=False))] = True
            jb, b = jgen.next_batch(), gen.next_batch()
            jout = ref.step_masked(jft.PacketBatch(*map(jnp.asarray, pad(jb, bucket, keep))),
                                   keep)
            out = port.step_masked(ft.PacketBatch(*map(torch.from_numpy, pad(b, bucket, keep))),
                                   keep)
            assert_outputs_equal(jout, out, f"{name} step {step}")
            outs.append(out)
    else:
        pending = None
        for step in range(STEPS):
            jout = ref.step(jgen.next_batch())
            out = port.step(gen.next_batch())
            if mode == "overlap":
                jout = jout.wait()
                assert isinstance(out, InflightDispatch)
                if pending is not None:
                    outs.append(pending.wait())  # waited one behind, as run() does
                pending = out
                out = out.wait()
            else:
                outs.append(out)
            assert_outputs_equal(jout, out, f"{name} step {step}")
        if pending is not None:
            outs.append(pending.wait())
    return ref, port, outs


@pytest.fixture(scope="module")
def runs(models):
    cache = {}

    def get(name: str):
        if name not in cache:
            cache[name] = drive(models, name)
        return cache[name]

    return get


# ------------------------------------------------------------ partition

def random_batch(rng, n, pool, pay_bytes=4):
    """Numpy leaves of a batch whose hashes come from ``pool``."""
    return [np.cumsum(rng.integers(1, 50, n)).astype(np.int32),
            rng.integers(40, 1500, n).astype(np.int32), rng.integers(0, 2, n).astype(np.int32),
            rng.integers(0, 64, n).astype(np.int32), rng.integers(0, 3, n).astype(np.int32),
            rng.choice(pool, n).astype(np.int32),
            rng.integers(0, 256, (n, pay_bytes)).astype(np.int32)]


@pytest.mark.parametrize("num_shards", [1, 2, 3, 4])
@pytest.mark.parametrize("seed", range(3))
def test_partition_batch_matches_reference(seed, num_shards):
    """Every round's shards, keep and src equal the reference's, with
    negative hashes in the pool, with and without ``lane_batch`` and the
    ``keep`` pre-drop; ``lane_rounds`` agrees with the rounds."""
    rng = np.random.default_rng(seed)
    pool = np.concatenate([np.arange(1, 12), -np.arange(1, 9), [-(2**31), 2**31 - 1]])
    leaves = random_batch(rng, 32, pool)
    keep = rng.random(32) < 0.7
    for kw in (dict(), dict(lane_batch=5), dict(keep=keep), dict(lane_batch=3, keep=keep)):
        want = j_partition_batch(jft.PacketBatch(*map(jnp.asarray, leaves)), num_shards, **kw)
        got = partition_batch(ft.PacketBatch(*map(torch.from_numpy, leaves)), num_shards, **kw)
        assert len(got) == len(want), kw
        for r, (w, g) in enumerate(zip(want, got)):
            for name, a, b in zip(("shards", "keep", "src"), w, g):
                for x, y in zip(to_np(a) if name == "shards" else [a],
                                to_np(b) if name == "shards" else [b]):
                    np.testing.assert_array_equal(np.asarray(x), y.numpy() if isinstance(
                        y, torch.Tensor) else y, err_msg=f"{kw} round {r} {name}")
        _, rnd, rounds = lane_rounds(leaves[5], num_shards, **kw)
        assert rounds == len(want)
        for r, w in enumerate(want):
            src = np.asarray(w.src)[np.asarray(w.keep)]
            assert sorted(src.tolist()) == np.flatnonzero(rnd == r).tolist()


def test_partition_and_shard_of_errors_and_devices():
    """The reference's argument errors and messages; ``shard_of`` equal on
    tensors, numpy arrays and ints, negative int32 hashes included."""
    leaves = random_batch(np.random.default_rng(0), 8, np.arange(1, 5))
    jb = jft.PacketBatch(*map(jnp.asarray, leaves))
    b = ft.PacketBatch(*map(torch.from_numpy, leaves))
    for args, kw in (((0,), {}), ((2,), dict(lane_batch=0)), ((2,), dict(lane_batch=9)),
                     ((2,), dict(keep=np.ones(7, bool)))):
        with pytest.raises(ValueError) as want:
            j_partition_batch(jb, *args, **kw)
        with pytest.raises(ValueError) as got:
            partition_batch(b, *args, **kw)
        assert str(got.value) == str(want.value)
    hashes = np.random.default_rng(1).integers(-(2**31), 2**31 - 1, 300).astype(np.int32)
    for S in (1, 2, 3, 4, 8):
        want = np.asarray(j_shard_of(jnp.asarray(hashes), S))
        np.testing.assert_array_equal(shard_of(torch.from_numpy(hashes), S).numpy(), want)
        np.testing.assert_array_equal(shard_of(hashes, S), want)
        assert [shard_of(int(h), S) for h in hashes[:50]] == [j_shard_of(int(h), S)
                                                              for h in hashes[:50]]


def test_traffic_client_id_and_adv_shards_draw_like_reference():
    """``client_id`` is stamped on the generator; ``adv_shards`` pins every
    attacking flow to lane 0 with the reference's draws (its scaled
    ``tries`` bound included)."""
    cfg = dict(ATTACK, client_id=5)
    jgen, gen = JTrafficGenerator(JTrafficConfig(**cfg)), TrafficGenerator(
        TrafficConfig(**cfg), device="cpu")
    assert gen.client_id == jgen.client_id == 5
    for _ in range(4):
        for a, b in zip(jgen.next_batch(), gen.next_batch()):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert (shard_of(gen.next_batch().tuple_hash, 4) == 0).all()
    with pytest.raises(ValueError, match="adv_shards"):
        TrafficConfig(adv_shards=-1)


# ------------------------------------------------------------ the pipeline

@pytest.mark.parametrize("name", list(CASES))
def test_sharded_matches_reference(runs, name):
    """Every step bit for bit (in ``drive``), then the stacked state, rules,
    counters and ``explain()``."""
    ref, port, _ = runs(name)
    S = CASES[name][0]
    state = port.state  # under shard_map the lanes' states, stacked
    jleaves, leaves = to_np(jax.tree_util.tree_leaves(ref.state)), to_np(state)
    assert len(jleaves) == len(leaves)
    for a, b in zip(jleaves, leaves):
        np.testing.assert_array_equal(a, b)
    if port.cfg.cold_size:
        assert state.hot.count.shape == (S, 64) and state.cold.tick.shape == (S,)
        conv = convert.two_level_state_from_numpy(
            [np.asarray(x) for x in ref.state.hot], [np.asarray(x) for x in ref.state.cold],
            device="cpu")
    else:
        assert state.count.shape == (S, 64)
        conv = convert.tracker_state_from_numpy([np.asarray(x) for x in ref.state], device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(to_tensors(conv), to_tensors(state)))
    assert ref.rules.rules == port.rules.rules
    for count in COUNTS:
        assert getattr(port.stats, count) == getattr(ref.stats, count), count
    assert port.explain().replace(f"backend={port.backend}", "backend=vmap") == ref.explain()
    assert ref.stats.flows > 0 or port.cfg.cold_size


def test_rounds_and_attack_exercise_their_paths(runs):
    """The multi-round and attack cases really overflowed, and the attack
    took the scan fallback and put every packet in lane 0; the cold lanes'
    clocks diverged."""
    _, rounds, _ = runs("s4_rounds")
    assert rounds.stats.dispatches > STEPS
    _, attack, _ = runs("s4_attack")
    assert attack.stats.dispatches == 4 * STEPS  # 24 packets / lane_batch 6
    assert attack.stats.fallback_steps == STEPS and attack.stats.evicted > 0
    assert int(attack.state.count[1:].sum()) == 0
    _, lru, _ = runs("s4_cold_lru_rounds")
    ticks = lru.state.cold.tick
    assert lru.stats.spilled > 0 and lru.stats.promoted > 0 and len(set(ticks.tolist())) > 1


def test_sharded_matches_single_lane_port(runs, models):
    """Collision-free traffic, no lane backlog: the union of drained flows,
    the decisions, the rule table and the live rows (modulo lane) equal the
    port's single-lane pipeline on the same stream."""
    _, port, outs = runs("s4")
    mlp, tf = models["mlp"][1], models["transformer"][1]
    single = OctopusPipeline(mlp, tf, PipelineConfig(**SHAPE), device="cpu")
    gen = TrafficGenerator(TrafficConfig(**TRAFFIC), device="cpu")

    def drained(out, dst):
        m = out.drained.mask
        for i in np.flatnonzero(m.numpy()):
            dst.setdefault(int(out.drained.tuple_id[i]), []).append(
                (int(out.drained.slots[i]), out.drained.series[i].tolist(),
                 out.drained.payload[i].tolist(), int(out.flow_cls[i])))

    want, got = {}, {}
    for out in outs:
        o = single.step(gen.next_batch())
        assert torch.equal(o.pkt_actions, out.pkt_actions)
        assert int(ft.ready_mask(single.state, top_n=SHAPE["top_n"]).sum()) == 0
        drained(o, want)
        drained(out, got)
    assert want and want == got
    assert single.rules.rules == port.rules.rules
    live = (single.state.count > 0).nonzero().squeeze(1)
    lanes = shard_of(single.state.tuple_id[live], 4)
    for name, a, b in zip(ft.TrackerState._fields, single.state, port.state):
        assert torch.equal(a[live], b[lanes.long(), live]), name


def test_constructor_errors_match_reference(models):
    (jmlp, mlp), (jcnn, cnn) = models["mlp"], models["cnn"]
    cfg = dict(batch_size=8, max_ready=4, flow_model="cnn", table_size=64)
    for kw, pcfg in ((dict(num_shards=0), cfg), (dict(num_shards=3), cfg),
                     (dict(num_shards=2, lane_batch=9), cfg),
                     (dict(num_shards=2, backend="pmap"), cfg),
                     (dict(num_shards=2, lane_batch=4), dict(cfg, scan_len=2))):
        with pytest.raises(ValueError) as want:
            JShardedOctopusPipeline(jmlp, jcnn, JPipelineConfig(**pcfg), **kw)
        with pytest.raises(ValueError) as got:
            ShardedOctopusPipeline(mlp, cnn, PipelineConfig(**pcfg), device="cpu", **kw)
        assert str(got.value) == str(want.value)
    # the shard_map lanes need a device a lane, as the reference's (this host
    # gives the reference one device; the port is given one by name)
    with pytest.raises(ValueError) as want:
        JShardedOctopusPipeline(jmlp, jcnn, JPipelineConfig(**cfg), num_shards=2,
                                backend="shard_map")
    with pytest.raises(ValueError) as got:
        ShardedOctopusPipeline(mlp, cnn, PipelineConfig(**cfg), num_shards=2,
                               backend="shard_map", devices=["cpu"])
    assert str(got.value) == str(want.value) == "need 2 devices for a lanes mesh, have 1"
    built = ShardedOctopusPipeline(mlp, cnn, PipelineConfig(**cfg), num_shards=2,
                                   backend="shard_map", devices=["cpu"] * 3)
    assert built.backend == "shard_map" and built.mesh.devices == (torch.device("cpu"),) * 2
    assert built.state.count.shape == (2, 64) and len(built.lanes) == 2
    with pytest.raises(ValueError, match="devices name the lanes"):
        ShardedOctopusPipeline(mlp, cnn, PipelineConfig(**cfg), num_shards=2, backend="vmap",
                               device="cpu", devices=["cpu"] * 2)
    # no backend named: the platform's choice, one lane-batched bank on one device
    assert ShardedOctopusPipeline(mlp, cnn, PipelineConfig(**cfg), num_shards=2,
                                  device="cpu").backend == "vmap"


@pytest.fixture(scope="module")
def port_models():
    """Seeded port weights, drawn by the port (no reference here: the
    port-only tests below hold two port pipelines to each other)."""
    from repro_torch.models import paper_models

    return {kind: paper_models.init_paper_model(kind, torch.Generator().manual_seed(seed),
                                                device="cpu")
            for kind, seed in (("mlp", 0), ("transformer", 2))}


# s2 (the segmented tracker at 2 lanes) is ``s2_shard_map`` above, held to
# the reference, which the vmap lanes equal on the same case
@pytest.mark.parametrize("name", ["s2_scan", "s4_cold_lru_rounds"])
def test_shard_map_lanes_match_vmap_lanes(port_models, name):
    """The shard_map lanes against the port's vmap lanes, each case's
    config on its stream (the scan tracker at 2 lanes; 4 lanes in rounds
    with cold lanes): every step's outputs, the stacked state, the rule
    table and the counters bit for bit; each lane's state its own."""
    S, over, sh_kw, traffic, _ = CASES[name]
    cfg = PipelineConfig(**SHAPE, **over)
    mlp, tf = port_models["mlp"], port_models["transformer"]
    vm = ShardedOctopusPipeline(mlp, tf, cfg, num_shards=S, device="cpu", **sh_kw)
    sm = ShardedOctopusPipeline(mlp, tf, cfg, num_shards=S, backend="shard_map",
                                devices=["cpu"] * S, **sh_kw)
    assert sm.backend == "shard_map" and vm.backend == "vmap"
    gen = TrafficGenerator(TrafficConfig(**traffic), device="cpu")
    for _ in range(STEPS):
        batch = gen.next_batch()
        a, b = vm.step(batch), sm.step(batch)
        assert all(torch.equal(x, y) for x, y in zip(to_tensors(a), to_tensors(b)))
    assert all(torch.equal(x, y) for x, y in zip(to_tensors(sm.state), to_tensors(vm.state)))
    assert sm.mesh.devices == (torch.device("cpu"),) * S
    assert sm.rules.rules == vm.rules.rules
    for count in COUNTS + ("fallback_steps",):
        assert getattr(sm.stats, count) == getattr(vm.stats, count), count


def test_shard_map_state_is_the_stacked_state(port_models):
    """Under shard_map ``state`` reads as the vmap backend's stacked type
    and an assigned stacked state reaches every lane: a pipeline restarted
    from another's state steps on as that one does, and reading the state
    gives a copy that later steps leave alone."""
    cfg = PipelineConfig(**SHAPE, cold_size=32)
    mlp, tf = port_models["mlp"], port_models["transformer"]
    gen = TrafficGenerator(TrafficConfig(**SPILL), device="cpu")
    batches = [gen.next_batch() for _ in range(4)]
    vm = ShardedOctopusPipeline(mlp, tf, cfg, num_shards=2, device="cpu")
    for batch in batches[:2]:
        vm.step(batch)
    sm = ShardedOctopusPipeline(mlp, tf, cfg, num_shards=2, backend="shard_map",
                                devices=["cpu"] * 2)
    sm.state = vm.state
    before = sm.state
    assert type(before) is type(vm.state) and before.cold.tick.shape == (2,)
    assert all(torch.equal(x, y) for x, y in zip(to_tensors(before), to_tensors(vm.state)))
    for batch in batches[2:]:
        a, b = vm.step(batch), sm.step(batch)
        assert all(torch.equal(x, y) for x, y in zip(to_tensors(a), to_tensors(b)))
    assert all(torch.equal(x, y) for x, y in zip(to_tensors(sm.state), to_tensors(vm.state)))
    assert not all(torch.equal(x, y) for x, y in zip(to_tensors(before), to_tensors(sm.state)))


def test_default_backend_on_many_devices_runs_the_scenario(monkeypatch, port_models):
    """With as many devices as lanes and no backend named, the pipeline
    takes the shard_map lanes (as the reference's does), a lane a device of
    its backend; a scenario that reads the stacked state runs on them as on
    the vmap lanes."""
    from repro_torch.runtime import platform
    from repro_torch.scenarios.heavy_hitter import HeavyHitterScenario

    kw = dict(k=4, num_shards=2, pkt_params=port_models["mlp"],
              flow_params=port_models["transformer"], device="cpu", **SHAPE)
    gen = TrafficGenerator(TrafficConfig(**TRAFFIC), device="cpu")
    batches = [gen.next_batch() for _ in range(4)]
    vm = HeavyHitterScenario(**kw)
    assert vm.pipe.backend == "vmap"
    monkeypatch.setattr(platform, "device_count", lambda device=None: 2)
    sm = HeavyHitterScenario(**kw)
    assert sm.pipe.backend == "shard_map"
    assert sm.pipe.mesh.devices == (torch.device("cpu"),) * 2
    for batch in batches:
        vm.step(batch)
        sm.step(batch)
        assert sm.top_k() == vm.top_k() and sm.top_k()
    assert sm.counters() == vm.counters()


@pytest.mark.parametrize("devices", range(1, 9))
def test_lanes_backend_matches_reference(monkeypatch, devices):
    from repro.runtime import platform as jplatform
    from repro_torch.runtime import platform

    monkeypatch.setattr(jplatform, "device_count", lambda: devices)
    monkeypatch.setattr(platform, "device_count", lambda device=None: devices)
    for lanes in range(1, 10):
        assert platform.lanes_backend(lanes) == jplatform.lanes_backend(lanes), lanes


def test_plan_scopes_lanes_like_reference(models):
    """``plan()`` holds one ``lane<i>/`` scope a lane at the lane's shapes,
    equal to the reference's, and ``explain()`` its text, also in int8."""
    (jmlp, mlp), (jcnn, cnn) = models["mlp"], models["cnn"]
    cfg = dict(batch_size=16, max_ready=4, flow_model="cnn", table_size=64)
    ref = JShardedOctopusPipeline(jmlp, jcnn, JPipelineConfig(**cfg), num_shards=2)
    port = ShardedOctopusPipeline(mlp, cnn, PipelineConfig(**cfg), num_shards=2, device="cpu")
    plan = port.plan()
    assert len(plan.scoped("lane0")) == len(plan.scoped("lane1")) == 9
    assert [(s.name, s.m, s.k, s.n, s.engine) for s in plan.steps] == [
        (s.name, s.m, s.k, s.n, s.engine) for s in ref.plan().steps]
    assert "lane0: 4 pkt + 5 flow matmuls" in port.explain()
    assert port.explain() == ref.explain()


def test_step_many_dispatches_every_overflow_round(models):
    """With ``lane_batch`` under the batch, ``step_many`` of one batch runs
    every round (all 8 packets in lane 0: 4 rounds) and stacks the output."""
    mlp, tf = models["mlp"][1], models["transformer"][1]
    cfg = PipelineConfig(batch_size=8, max_ready=2, flow_model="transformer", table_size=16,
                         top_n=8, top_k=15, pay_bytes=16)
    sh = ShardedOctopusPipeline(mlp, tf, cfg, num_shards=2, lane_batch=2, device="cpu")
    h = 4
    assert shard_of(h, 2) == 0
    z = torch.zeros(8, dtype=torch.int32)
    batch = ft.PacketBatch(ts=torch.arange(1, 9, dtype=torch.int32) * 10, size=z + 100, dir=z,
                           flags=z, proto=z, tuple_hash=z + h,
                           payload=torch.zeros(8, 16, dtype=torch.int32))
    out = sh.step_many([batch])
    assert out.pkt_actions.shape == (1, 8)
    assert int(out.drained.mask.sum()) == 1
    assert (sh.stats.steps, sh.stats.packets, sh.stats.dispatches) == (1, 8, 4)
    with pytest.raises(ValueError, match="batch_size"):
        sh.step(ft.PacketBatch(*(a[:4] for a in batch)))
