"""The port's flow-feature ALU fold (``repro_torch.kernels.flow_features``)
against the JAX package, bit for bit: the 16-lane ALU and the ordered fold.

The reference fold is ``ref_flow_feature_update`` (a ``lax.scan``); the
Pallas kernel itself does not run on the installed JAX.  On CPU tensors the
port's wrapper runs its plain fold, which these tests hold to the reference;
the CUDA kernel is held to the plain fold on the card (test_torch_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flow_features import ref_flow_feature_update
from repro.kernels.flow_features import flow_features as jff
from repro.kernels.flow_features import ops as jops
from repro_torch.kernels.flow_features import ops as ff

INT_MIN, INT_MAX = np.iinfo(np.int32).min, np.iinfo(np.int32).max


def random_program(rng, *, cross_lane: bool) -> np.ndarray:
    ops = rng.permutation(np.arange(16) % 7)  # every op, in random lanes
    meta_src = rng.integers(0, ff.META_WIDTH, 16)
    hist_src = rng.integers(0, 16, 16) if cross_lane else np.arange(16)
    return np.stack([ops, meta_src, hist_src], axis=1).astype(np.int32)


def wrapping_ints(rng, shape) -> np.ndarray:
    """int32 values dense near both ends, so add/sub/inc wrap."""
    edge = rng.choice([INT_MIN, INT_MIN + 1, -1, 0, 1, INT_MAX - 1, INT_MAX], size=shape)
    mid = rng.integers(INT_MIN, INT_MAX, size=shape, endpoint=True)
    return np.where(rng.random(shape) < 0.5, edge, mid).astype(np.int32)


def jax_fold(program, slots, meta, table, keep=None) -> np.ndarray:
    """Reference fold with the port's drop rule: slot F (and keep == False)
    lands in a scratch row that is sliced off."""
    f = table.shape[0]
    if keep is not None:
        slots = np.where(keep, slots, f)
    ext = np.concatenate([table, np.zeros((1, 16), np.int32)])
    out = ref_flow_feature_update(jnp.asarray(program), jnp.asarray(slots, jnp.int32),
                                  jnp.asarray(meta), jnp.asarray(ext))
    return np.asarray(out)[:f]


def test_tables_match_reference():
    assert ff.META == jops.META and ff.HIST == jops.HIST
    assert ff.MICRO_OPS == jops.MICRO_OPS and ff.META_WIDTH == jops.META_WIDTH
    np.testing.assert_array_equal(ff.default_program_np(), jops.default_program_np())


@pytest.mark.parametrize("seed", range(4))
def test_apply_alu_program_matches_reference(seed):
    rng = np.random.default_rng(seed)
    program = random_program(rng, cross_lane=True)
    program[rng.integers(0, 16, 2), 0] = [7, -1]  # undefined opcodes keep the lane
    meta = wrapping_ints(rng, (32, ff.META_WIDTH))
    hist = wrapping_ints(rng, (32, 16))
    got = ff.apply_alu_program(torch.as_tensor(program), torch.as_tensor(meta),
                               torch.as_tensor(hist)).numpy()
    for i in range(32):
        want = jff.apply_alu_program(jnp.asarray(program), jnp.asarray(meta[i]),
                                     jnp.asarray(hist[i]))
        np.testing.assert_array_equal(got[i], np.asarray(want), err_msg=f"row {i}")


@pytest.mark.parametrize("case", ["default", "random_same_lane", "random_cross_lane",
                                  "colliding", "padding_and_keep"])
def test_fold_matches_reference(case):
    rng = np.random.default_rng(sum(map(ord, case)))
    F, P = 64, 300
    program = (ff.default_program_np() if case == "default"
               else random_program(rng, cross_lane=case != "random_same_lane"))
    slots = rng.integers(0, 4 if case == "colliding" else F, P).astype(np.int32)
    keep = None
    if case == "padding_and_keep":
        slots[rng.random(P) < 0.2] = F  # padding packets
        keep = rng.random(P) < 0.7
    meta = wrapping_ints(rng, (P, ff.META_WIDTH))
    table = wrapping_ints(rng, (F, 16))
    got = ff.fold_features(torch.as_tensor(program), torch.as_tensor(slots),
                           torch.as_tensor(meta), torch.as_tensor(table),
                           keep=None if keep is None else torch.as_tensor(keep))
    np.testing.assert_array_equal(got.numpy(), jax_fold(program, slots, meta, table, keep))


def test_fold_leaves_input_table_untouched():
    rng = np.random.default_rng(0)
    table = torch.as_tensor(wrapping_ints(rng, (8, 16)))
    before = table.clone()
    ff.flow_feature_update(ff.default_program("cpu"), torch.zeros(5, dtype=torch.int32),
                           torch.as_tensor(wrapping_ints(rng, (5, 13))), table)
    assert torch.equal(table, before)


def test_check_program_refuses_out_of_range_sources():
    ff.check_program(ff.default_program("cpu"))
    bad = ff.default_program("cpu").clone()
    bad[3, 2] = 16
    with pytest.raises(ValueError, match="hist_src"):
        ff.check_program(bad)
    with pytest.raises(ValueError, match="int32"):
        ff.check_program(bad.long())


def test_wrapper_dispatch_is_by_device():
    """No flag picks the plain fold: a CPU table gets it, any other device
    the kernel or an error."""
    meta_dev = torch.device("meta")
    args = [ff.default_program("cpu"), torch.zeros(3, dtype=torch.int32),
            torch.zeros(3, 13, dtype=torch.int32), torch.zeros(4, 16, dtype=torch.int32)]
    with pytest.raises(ValueError, match="no kernel"):
        ff.flow_feature_update(*(a.to(meta_dev) for a in args))


def test_kernel_launch_counts_only_accepted_launches(monkeypatch):
    """A launch the CUDA runtime refuses raises and is not counted (device -1: no
    device switch)."""
    from repro_torch.kernels import build

    fake_lib = type("Lib", (), {"octo_error_string": staticmethod(lambda err: b"refused")})()
    monkeypatch.setattr(build, "_lib", fake_lib)
    kernel = build.CudaKernel("fake_launch", [])
    kernel._fn = lambda *args: 9
    with pytest.raises(RuntimeError, match="CUDA error 9 .refused"):
        kernel(-1)
    assert kernel.launches == 0
    kernel._fn = lambda *args: 0
    kernel(-1)
    assert kernel.launches == 1


def test_kernel_build_refuses_without_nvcc(monkeypatch):
    from repro_torch.kernels import build

    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()
