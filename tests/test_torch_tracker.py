"""The port's tracker (``repro_torch.core.flow_tracker`` and
``feature_extractor``) against the JAX package, bit for bit: hashing, the
scan oracle, the segmented update under every fallback mode, and the drain.

Traces come from the JAX package's own traffic generator (collision-free and
collision-attack) and convert through numpy; masks come from numpy seeds.
The JAX segmented update runs without ``use_pallas`` (its Pallas fold does
not run on the installed JAX); the port folds through its plain ALU fold,
which must give the same table."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import feature_extractor as jfx
from repro.core import flow_tracker as jft
from repro.data.traffic import TrafficConfig as JTrafficConfig
from repro.data.traffic import TrafficGenerator as JTrafficGenerator
from repro_torch import convert
from repro_torch.core import feature_extractor as fx
from repro_torch.core import flow_tracker as ft
from repro_torch.kernels.flow_features.ops import default_program

F, TOP_N, TOP_K, PAY = 128, 20, 15, 16
j_segmented_update = jax.jit(jfx.segmented_update, static_argnames=("top_n", "fallback"))
j_drain_ready = jax.jit(jft.drain_ready, static_argnames=("top_n", "max_ready"))


def assert_tuple_equal(want, got, what: str):
    for name, a, b in zip(want._fields, want, convert.to_numpy(got)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=f"{what}.{name}")


def traffic(attack: bool, steps: int, seed: int):
    cfg = JTrafficConfig(batch_size=96, active_flows=24 if attack else 64, table_size=F,
                         seed=seed, **(dict(adversarial="collision_attack",
                                            collision_free=False, adv_slots=6)
                                       if attack else {}))
    gen = JTrafficGenerator(cfg)
    return [gen.next_batch() for _ in range(steps)]


def to_port(batch) -> ft.PacketBatch:
    return convert.packet_batch_from_numpy([np.asarray(a) for a in batch], device="cpu")


def test_hash_slot_matches_reference_on_extreme_hashes():
    rng = np.random.default_rng(0)
    hashes = np.concatenate([
        np.array([0, 1, -1, 2**31 - 1, -2**31, -2**31 + 1, 0x7FFF0000, -0x10000], np.int32),
        rng.integers(-2**31, 2**31, 4096).astype(np.int32)])
    for size in (8, 1000, 8192):
        want = np.asarray(jft.hash_slot(jnp.asarray(hashes), size))
        got = ft.hash_slot(torch.as_tensor(hashes), size).numpy()
        np.testing.assert_array_equal(got, want)
        assert [ft.hash_slot_scalar(int(h), size) for h in hashes[:64]] == list(want[:64])


def test_init_state_and_build_meta_match_reference():
    assert_tuple_equal(jft.init_state(F, TOP_N, TOP_K, PAY),
                       ft.init_state(F, TOP_N, TOP_K, PAY, device="cpu"), "TrackerState")
    batch = traffic(False, 1, seed=2)[0]
    intv = np.random.default_rng(1).integers(-5, 10_000, 96).astype(np.int32)
    want = jax.vmap(jft.build_meta)(batch, jnp.asarray(intv))
    np.testing.assert_array_equal(
        ft.build_meta(to_port(batch), torch.as_tensor(intv)).numpy(), np.asarray(want))


@pytest.mark.parametrize("attack", [False, True], ids=["collision_free", "collision_attack"])
def test_process_packets_matches_reference(attack):
    rng = np.random.default_rng(3)
    prog_j = jnp.asarray(np.asarray(jfx.default_program()))
    prog = default_program("cpu")
    js = jft.init_state(F, TOP_N, TOP_K, PAY)
    ts = ft.init_state(F, TOP_N, TOP_K, PAY, device="cpu")
    for i, batch in enumerate(traffic(attack, 4, seed=5)):
        keep = None if i == 0 else rng.random(96) < 0.8
        js, jout = jft.process_packets(js, batch, prog_j, top_n=TOP_N,
                                       keep=None if keep is None else jnp.asarray(keep))
        ts, tout = ft.process_packets(ts, to_port(batch), prog, top_n=TOP_N,
                                      keep=None if keep is None else torch.as_tensor(keep))
        assert_tuple_equal(js, ts, f"step {i} TrackerState")
        assert_tuple_equal(jout, tout, f"step {i} StepOut")


@pytest.mark.parametrize("fallback", ["auto", "always", "never"])
@pytest.mark.parametrize("attack", [False, True], ids=["collision_free", "collision_attack"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "keep"])
def test_segmented_update_and_drain_match_reference(fallback, attack, masked):
    rng = np.random.default_rng(11)
    js = jft.init_state(F, TOP_N, TOP_K, PAY)
    ts = ft.init_state(F, TOP_N, TOP_K, PAY, device="cpu")
    saw_collision = False
    for i, batch in enumerate(traffic(attack, 5, seed=7)):
        keep = rng.random(96) < 0.75 if masked else None
        jk = None if keep is None else jnp.asarray(keep)
        tk = None if keep is None else torch.as_tensor(keep)
        js, jo = j_segmented_update(js, batch, top_n=TOP_N, keep=jk, fallback=fallback)
        ts, to = fx.segmented_update(ts, to_port(batch), top_n=TOP_N, keep=tk,
                                     fallback=fallback)
        assert_tuple_equal(js, ts, f"step {i} TrackerState")
        assert_tuple_equal(jo, to, f"step {i} SegmentedOut")
        assert bool(fx.batch_collisions(to_port(batch), F, tk)) == bool(
            jfx.batch_collisions(batch, F, jk))
        saw_collision |= int(to.fallback_slots) > 0
        js, jd = j_drain_ready(js, top_n=TOP_N, max_ready=6)
        ts, td = ft.drain_ready(ts, top_n=TOP_N, max_ready=6)
        assert_tuple_equal(js, ts, f"step {i} drained TrackerState")
        assert_tuple_equal(jd, td, f"step {i} DrainResult")
    assert saw_collision or not attack


def test_segmented_update_equals_scan_oracle_for_custom_program():
    """A program the reference's segment reductions cannot express: the
    port's fold runs it, and the merge still equals the scan oracle."""
    rng = np.random.default_rng(4)
    program = default_program("cpu").clone()
    program[14] = torch.tensor([3, 11, 2], dtype=torch.int32)  # sub, crossing lanes
    program[15] = torch.tensor([4, 1, 14], dtype=torch.int32)  # max over lane 14
    s1 = s2 = ft.init_state(F, TOP_N, TOP_K, PAY, device="cpu")
    for batch in traffic(True, 3, seed=9):
        keep = torch.as_tensor(rng.random(96) < 0.9)
        s1, _ = fx.segmented_update(s1, to_port(batch), program, top_n=TOP_N, keep=keep)
        s2, _ = ft.process_packets(s2, to_port(batch), program, top_n=TOP_N, keep=keep)
        for name, a, b in zip(ft.TrackerState._fields, s1, s2):
            assert torch.equal(a, b), name


def test_release_flows_matches_reference_and_ignores_sentinel():
    js = jft.init_state(F, TOP_N, TOP_K, PAY)
    batch = traffic(False, 1, seed=1)[0]
    js, _ = jft.process_packets(js, batch, jnp.asarray(np.asarray(jfx.default_program())),
                                top_n=TOP_N)
    ts = convert.tracker_state_from_numpy([np.asarray(a) for a in js], device="cpu")
    slots = np.array([3, F, 17, F - 1, 3], np.int32)
    assert_tuple_equal(jft.release_flows(js, jnp.asarray(slots)),
                       ft.release_flows(ts, torch.as_tensor(slots)), "released")
    with pytest.raises(ValueError, match="max_ready"):
        ft.drain_ready(ts, top_n=TOP_N, max_ready=F + 1)


def test_whole_and_packet_features_match_reference():
    js = jft.init_state(F, TOP_N, TOP_K, PAY)
    batch = traffic(False, 1, seed=6)[0]
    js, _ = jft.process_packets(js, batch, jnp.asarray(np.asarray(jfx.default_program())),
                                top_n=TOP_N)
    np.testing.assert_array_equal(
        fx.derive_whole_features(torch.as_tensor(np.array(js.features))).numpy(),
        np.asarray(jfx.derive_whole_features(js.features)))
    np.testing.assert_array_equal(fx.packet_meta_features(to_port(batch)).numpy(),
                                  np.asarray(jfx.packet_meta_features(batch)))


def test_check_default_program():
    fx.check_default_program(default_program("cpu"))
    other = default_program("cpu").clone()
    other[14, 0] = 2
    with pytest.raises(ValueError, match="default micro-op program"):
        fx.check_default_program(other)
