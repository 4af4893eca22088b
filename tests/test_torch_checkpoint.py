"""The port's checkpoints: round trip, atomic writes, retention, the async
writer, a missing leaf, a leaf of another shape; and the on-disk format shared with the JAX package,
restored both ways bit for bit (parameters and an ``AdamState``, one leaf
bf16)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as jload_pytree
from repro.checkpoint import save_pytree as jsave_pytree
from repro.optim.optimizers import AdamState as JAdamState
from repro_torch.checkpoint import CheckpointManager, load_pytree, save_pytree
from repro_torch.common.tree import tree_items, tree_map
from repro_torch.optim import AdamState


def tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nested": {"b": torch.tensor([1.5, -2.25], dtype=torch.bfloat16),
                       "c": torch.tensor(3, dtype=torch.int32)}}


def zeros_like(t):
    return tree_map(torch.zeros_like, t)


def assert_trees_equal(a, b):
    items_a, items_b = list(tree_items(a)), list(tree_items(b))
    assert [k for k, _ in items_a] == [k for k, _ in items_b]
    for (key, x), (_, y) in zip(items_a, items_b):
        assert x.dtype == y.dtype and x.shape == y.shape, key
        assert torch.equal(x, y), key


def test_roundtrip(tmp_path):
    t = tree()
    path = save_pytree(t, str(tmp_path), step=7, extra={"note": "hi"})
    assert os.path.basename(path) == "step_00000007"
    restored, extra = load_pytree(path, zeros_like(t))
    assert extra == {"note": "hi"}
    assert_trees_equal(restored, t)
    # restored in the type of the leaf it restores into
    as_f32, _ = load_pytree(path, {"a": torch.zeros(3, 4, dtype=torch.bfloat16),
                                   "nested": {"b": torch.zeros(2), "c": torch.zeros((), dtype=torch.int32)}})
    assert as_f32["a"].dtype == torch.bfloat16 and as_f32["nested"]["b"].dtype == torch.float32
    assert torch.equal(as_f32["nested"]["b"], t["nested"]["b"].float())


def test_atomic_no_tmp_left(tmp_path):
    save_pytree(tree(), str(tmp_path), step=1)
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    with open(tmp_path / "step_00000001" / "manifest.json") as f:
        manifest = json.load(f)
    assert [leaf["key"] for leaf in manifest["leaves"]] == ["['a']", "['nested']['b']",
                                                            "['nested']['c']"]
    assert manifest["leaves"][1]["dtype"] == "bfloat16" and manifest["leaves"][1]["shape"] == [2]


def test_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_writes=False)
    for s in (1, 2, 3, 4):
        mgr.save(tree(), s)
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4


def test_async_save_snapshots_then_restores(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_writes=True)
    t = tree()
    mgr.save(t, 5, extra={"next_step": 5})
    t["a"].add_(100.0)  # the train step updates in place right after save
    mgr.wait()
    restored, extra, step = mgr.restore(zeros_like(tree()))
    assert step == 5 and extra["next_step"] == 5
    assert_trees_equal(restored, tree())


def test_async_error_surfaces_on_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_writes=True)
    (tmp_path / "step_00000001.tmp").write_text("a file where the writer wants a directory")
    mgr.save(tree(), 1)
    with pytest.raises(NotADirectoryError):
        mgr.wait()
    mgr.wait()  # raised once
    assert mgr.all_steps() == []


def test_missing_leaf_raises(tmp_path):
    path = save_pytree({"a": torch.ones(3)}, str(tmp_path), step=1)
    with pytest.raises(KeyError, match=r"\['b'\]"):
        load_pytree(path, {"a": torch.zeros(3), "b": torch.zeros(2)})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({"a": torch.zeros(3)})


def test_leaf_of_another_shape_raises(tmp_path):
    """A checkpoint of another arch (a leaf of another shape) is refused, not
    restored into the wrong structure."""
    path = save_pytree({"a": torch.ones(3), "b": torch.ones(2, 4)}, str(tmp_path), step=1)
    with pytest.raises(ValueError, match=r"\['b'\] of shape \(2, 4\), expected \(4, 2\)"):
        load_pytree(path, {"a": torch.zeros(3), "b": torch.zeros(4, 2)})


# ---------------------------------------------------------------- across packages


def _state(rng):
    """Parameters and an AdamState over them, the embedding bf16, as numpy."""
    params = {"blocks": {"w": rng.normal(size=(2, 3, 4)).astype(np.float32)},
              "embed": rng.normal(size=(5, 4)).astype(np.float32),
              "norm": rng.normal(size=(4,)).astype(np.float32)}
    mu = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), params)
    nu = jax.tree.map(lambda a: rng.random(size=a.shape).astype(np.float32), params)
    return params, mu, nu


def _jax_tree(params, mu, nu):
    p = jax.tree.map(jnp.asarray, params)
    p["embed"] = p["embed"].astype(jnp.bfloat16)
    return {"params": p, "opt": JAdamState(mu=jax.tree.map(jnp.asarray, mu),
                                           nu=jax.tree.map(jnp.asarray, nu))}


def _port_tree(params, mu, nu):
    p = tree_map(torch.from_numpy, params)
    p["embed"] = p["embed"].to(torch.bfloat16)
    return {"params": p, "opt": AdamState(mu=tree_map(torch.from_numpy, mu),
                                          nu=tree_map(torch.from_numpy, nu))}


def _equal_across(port, ref):
    ref_items = jax.tree_util.tree_flatten_with_path(ref)[0]
    port_items = list(tree_items(port))
    assert [k for k, _ in port_items] == [jax.tree_util.keystr(k) for k, _ in ref_items]
    for (key, got), (_, want) in zip(port_items, ref_items):
        assert str(got.dtype)[6:] == str(want.dtype), key
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32),
                                      err_msg=key)


def test_the_references_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    rng = np.random.default_rng(0)
    state = _state(rng)
    ref = _jax_tree(*state)
    path = jsave_pytree(ref, str(tmp_path), step=3, extra={"next_step": 3})
    like = tree_map(torch.zeros_like, _port_tree(*_state(np.random.default_rng(1))))
    restored, extra = load_pytree(path, like)
    assert extra == {"next_step": 3}
    assert type(restored["opt"]) is AdamState
    _equal_across(restored, ref)


def test_the_ports_checkpoint_restores_in_the_reference_bit_for_bit(tmp_path):
    rng = np.random.default_rng(2)
    state = _state(rng)
    port = _port_tree(*state)
    mgr = CheckpointManager(str(tmp_path), async_writes=True)
    mgr.save(port, 4, extra={"next_step": 4})
    mgr.wait()
    like = jax.tree.map(jnp.zeros_like, _jax_tree(*_state(np.random.default_rng(3))))
    restored, extra = jload_pytree(mgr.path_for(4), like)
    assert extra == {"next_step": 4}
    _equal_across(port, restored)
    ref_path = jsave_pytree(_jax_tree(*state), str(tmp_path / "ref"), step=4,
                            extra={"next_step": 4})
    assert sorted(os.listdir(ref_path)) == sorted(os.listdir(mgr.path_for(4)))
