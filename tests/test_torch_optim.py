"""The port's token pipeline, optimizers, clipping, schedule and int8 gradient
compression against the JAX package.

Tolerances.  Token batches: equal.  Optimizer updates, one and three from
the same params, grads and step: parameters and every state leaf within
rtol 1e-6 (atol 1e-6 * max|ref| of the leaf: the means and square roots may
round apart in the last bit).  The schedule at every step: rtol 1e-6.
Clipping: the norm within rtol 1e-6, the grads within 1e-6 * max|ref|.
Compression: the int8 codes equal, the dequantized grads within rtol 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.tokens import TokenPipeline as JTokenPipeline
from repro.data.tokens import TokenPipelineConfig as JTokenPipelineConfig
from repro.distributed import compression as jcomp
from repro.optim import optimizers as jopt
from repro_torch.common.tree import tree_items, tree_leaves, tree_map
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.distributed import compression
from repro_torch.optim import optimizers as opt

RTOL = 1e-6


def close(got, want, rtol=RTOL, what=""):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def trees_close(port, ref, rtol=RTOL):
    ref_items = dict((jax.tree_util.keystr(k), v)
                     for k, v in jax.tree_util.tree_flatten_with_path(ref)[0])
    port_items = dict(tree_items(port))
    assert sorted(port_items) == sorted(ref_items)
    for key, leaf in port_items.items():
        assert leaf.dtype == getattr(torch, str(ref_items[key].dtype)), key
        close(leaf, ref_items[key], rtol, what=key)


# ---------------------------------------------------------------- tokens


@pytest.mark.parametrize("seed,num_shards", [(0, 1), (3, 2), (7, 4)])
def test_token_batches_equal_the_references(seed, num_shards):
    for shard in range(num_shards):
        kw = dict(vocab_size=97, seq_len=24, global_batch=8, seed=seed, num_shards=num_shards,
                  shard=shard, branching=3)
        port, ref = TokenPipeline(TokenPipelineConfig(**kw)), JTokenPipeline(JTokenPipelineConfig(**kw))
        np.testing.assert_array_equal(port.table, ref.table)
        for step in (0, 1, 5, 17):
            got, want = port.batch(step), ref.batch(step)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(got[k], want[k])
                assert got[k].dtype == want[k].dtype
        assert port.state(9) == ref.state(9)
        assert port.local_batch == ref.local_batch
    with pytest.raises(ValueError, match="does not split"):
        TokenPipeline(TokenPipelineConfig(global_batch=6, num_shards=4))


# ---------------------------------------------------------------- optimizers


def _tree(rng):
    """A parameter-like tree of f32 arrays: a stacked 3-D leaf, a matrix, a
    vector and a one-element leaf."""
    tree = {"blocks": {"w": rng.normal(size=(2, 6, 5))},
            "embed": rng.normal(size=(7, 4)),
            "norm": rng.normal(size=(5,)),
            "one": rng.normal(size=(1,))}
    return jax.tree.map(lambda a: a.astype(np.float32), tree)


def _port(tree, bf16_key=None):
    """The tree as f32 tensors, the top-level leaf ``bf16_key`` bf16."""
    return {k: _port(v) if isinstance(v, dict) else
            torch.tensor(v, dtype=torch.bfloat16 if k == bf16_key else torch.float32)
            for k, v in tree.items()}


def _ref(tree, bf16_key=None):
    return {k: _ref(v) if isinstance(v, dict) else
            jnp.asarray(v, jnp.bfloat16 if k == bf16_key else jnp.float32)
            for k, v in tree.items()}


OPTIMIZERS = {
    "adamw": (lambda m, lr: m.adamw(lr, weight_decay=0.1)),
    "adafactor": (lambda m, lr: m.adafactor(lr, weight_decay=0.05)),
    "sgd": (lambda m, lr: m.sgd(lr)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
@pytest.mark.parametrize("updates,start", [(1, 0), (3, 4)])
@pytest.mark.parametrize("bf16_key", [None, "embed"])
def test_optimizer_updates_match_the_references(name, updates, start, bf16_key):
    rng = np.random.default_rng(1)
    params0 = _tree(rng)
    grads = [_tree(rng) for _ in range(updates)]
    make = OPTIMIZERS[name]
    p_opt = make(opt, opt.cosine_schedule(3e-2, 2, 10))
    j_opt = make(jopt, jopt.cosine_schedule(3e-2, 2, 10))
    params, jparams = _port(params0, bf16_key), _ref(params0, bf16_key)
    state, jstate = p_opt.init(params), j_opt.init(jparams)
    trees_close(state, jstate)
    for i, g in enumerate(grads):
        params, state = p_opt.update(_port(g, bf16_key), state, params, start + i)
        jparams, jstate = j_opt.update(_ref(g, bf16_key), jstate, jparams,
                                       jnp.asarray(start + i, jnp.int32))
        trees_close(params, jparams)
        trees_close(state, jstate)
    assert type(state).__name__ == type(jstate).__name__


def test_optimizers_take_a_constant_rate_and_refuse_unknown_names():
    rng = np.random.default_rng(2)
    params0, g = _tree(rng), _tree(rng)
    for name in ("adamw", "adafactor", "sgd"):
        p, s = opt.make_optimizer(name, 1e-2).update(
            _port(g), opt.make_optimizer(name, 1e-2).init(_port(params0)), _port(params0), 0)
        jo = jopt.make_optimizer(name, 1e-2)
        jp, _ = jo.update(_ref(g), jo.init(_ref(params0)), _ref(params0), jnp.asarray(0))
        trees_close(p, jp)
    with pytest.raises(ValueError, match="unknown optimizer"):
        opt.make_optimizer("lion", 1e-2)


def test_adafactor_state_is_factored_with_a_scalar_column_for_vectors():
    state = opt.adafactor(0.01).init({"w": torch.zeros(2, 64, 32), "b": torch.zeros(32)})
    assert tuple(state.vr["w"].shape) == (2, 64) and tuple(state.vc["w"].shape) == (2, 32)
    assert tuple(state.vr["b"].shape) == (32,) and state.vc["b"].dim() == 0


def test_cosine_schedule_matches_the_reference_at_every_step():
    for warmup, total, ratio in ((3, 10, 0.1), (0, 6, 0.0), (5, 5, 0.2)):
        port, ref = (opt.cosine_schedule(3e-4, warmup, total, ratio),
                     jopt.cosine_schedule(3e-4, warmup, total, ratio))
        for step in range(total + 3):
            got = port(step)
            assert got.dtype == torch.float32 and got.dim() == 0
            close(got, ref(jnp.asarray(step)), what=f"step {step}")


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_the_reference(max_norm):
    rng = np.random.default_rng(3)
    g = _tree(rng)
    got, gnorm = opt.clip_by_global_norm(_port(g, "embed"), max_norm)
    want, jnorm = jopt.clip_by_global_norm(_ref(g, "embed"), max_norm)
    close(gnorm, jnorm)
    trees_close(got, want)


def test_tree_helpers_follow_the_references_flattening():
    state = opt.AdamState(mu={"b": torch.zeros(1), "a": {"y": torch.ones(1), "x": torch.ones(2)}},
                          nu=[torch.zeros(3)])
    keys = [k for k, _ in tree_items({"opt": state})]
    jstate = jax.tree.map(np.asarray, jopt.AdamState(
        mu={"b": np.zeros(1), "a": {"y": np.ones(1), "x": np.ones(2)}}, nu=[np.zeros(3)]))
    assert keys == [jax.tree_util.keystr(k)
                    for k, _ in jax.tree_util.tree_flatten_with_path({"opt": jstate})[0]]
    assert [t.numel() for t in tree_leaves(state)] == [2, 1, 1, 3]  # a.x, a.y, b, nu
    doubled = tree_map(lambda a, b: a + b, state, state)
    assert type(doubled) is opt.AdamState and torch.equal(doubled.mu["a"]["x"], 2 * torch.ones(2))


# ---------------------------------------------------------------- compression


def test_int8_compression_matches_the_reference():
    rng = np.random.default_rng(4)
    g = _tree(rng)
    g["zero"] = np.zeros((3,), np.float32)
    g["ties"] = (np.arange(-6, 7, dtype=np.float32) * 0.5)  # scale 6/127: many half steps
    comp = compression.compress_tree(_port(g))
    jcompressed = jcomp.compress_tree(_ref(g))
    for (key, c), (_, jc) in zip(
            sorted(comp.items()), sorted(jcompressed.items())):
        if isinstance(c, dict):
            continue
        np.testing.assert_array_equal(c.q.numpy(), np.asarray(jc.q), err_msg=key)
        close(c.scale, jc.scale, what=key)
    trees_close(compression.decompress_tree(comp), jcomp.decompress_tree(jcompressed))
