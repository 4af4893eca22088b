"""The port's sharding rules and activation constraints against the JAX
package's, with no process group and no memory.

  * Rules: every registered arch at full width, on the meshes (16, 16),
    (2, 16, 16), (2, 4), (4, 2) and (1, 1), with ``fsdp`` on and off and
    ``moe_dp_attention`` on: each spec of the parameters, the optimizer
    state (AdamW and Adafactor), the inputs and the decode caches equals the
    reference's ``PartitionSpec`` leaf by leaf (trailing ``None``s dropped),
    and the replication reports are equal.  The reference side runs on a
    ``jax.sharding.AbstractMesh`` over ``jax.eval_shape`` trees, the port on
    an ``AbstractMesh`` over its specs' ``meta`` tensors.
  * ``shard_act``: on reduced qwen3-0.6b, xlstm-1.3b and llama-3.2-vision-90b
    forwards over a (2, 4) mesh, the sequence of (logical names, spec)
    equals the reference's (its superblocks unrolled and not rematerialised,
    so that each is traced, and its attention on the flash arm, the port's
    only one), recorded by wrapping its models' ``shard_act``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist_archs
from repro.configs import reduced_config as jreduced_config
from repro.distributed import act as jact
from repro.distributed import sharding as jshd
from repro.models import LM as JLM
from repro.models import layers as jlayers
from repro.models import recurrent as jrecurrent
from repro.models import transformer as jtransformer
from repro.models.spec import logical_axes as jlogical_axes
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch.common.tree import tree_items
from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.distributed import act
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import transformer as lm_mod
from repro_torch.models.spec import abstract_params, map_specs
from repro_torch.optim import make_optimizer

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")), "4x2": ((4, 2), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
LAYOUTS = {"fsdp": dict(fsdp=True), "no_fsdp": dict(fsdp=False),
           "moe_dp": dict(moe_dp_attention=True)}
CACHE = (4, 256)  # decode cache: batch, length
INPUT = (256, 64)  # the inputs' batch, sequence


def trimmed(spec) -> tuple:
    parts = list(spec)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


@functools.lru_cache(maxsize=None)
def trees(arch: str):
    """(reference abstract params, AdamW and Adafactor states, caches;
    the port's of each) at full width."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    jm = JLM(jcfg)
    jparams = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    specs = lm_mod.model_specs(cfg)
    params = abstract_params(specs)
    out = {"ref": {"params": jparams, "axes": jlogical_axes(jm.specs())},
           "port": {"params": params, "axes": map_specs(lambda s: s.axes, specs)}}
    for name in ("adamw", "adafactor"):
        out["ref"][name] = jax.eval_shape(jmake_optimizer(name, 1e-3).init, jparams)
        out["port"][name] = make_optimizer(name, 1e-3).init(params)
    if cfg.supports_decode:
        out["ref"]["cache"] = jax.eval_shape(lambda: jm.init_cache(*CACHE))
        out["port"]["cache"] = lm_mod.init_cache(cfg, *CACHE, device="meta")
    return out


def ref_items(tree):
    return [(jax.tree_util.keystr(path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def assert_same_specs(jtree, tree, what: str):
    want = [(k, trimmed(s.spec)) for k, s in ref_items(jtree)]
    got = [(k, s.spec) for k, s in tree_items(tree)]
    assert got == want, what


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", sorted(jlist_archs()))
def test_rules_match_reference(arch, mesh_name):
    assert list_archs() == sorted(jlist_archs())
    shape, axes = MESHES[mesh_name]
    jmesh, mesh = jax.sharding.AbstractMesh(shape, axes), AbstractMesh(shape, axes)
    t = trees(arch)
    ref, port = t["ref"], t["port"]
    for layout, kw in LAYOUTS.items():
        jcfg, cfg = jget_config(arch).replace(**kw), get_config(arch).replace(**kw)
        what = f"{arch} {mesh_name} {layout}"
        jrep, rep = [], []
        jsh = jshd.shardings_for(ref["axes"], ref["params"], jcfg, jmesh, jrep)
        sh = shd.shardings_for(port["axes"], port["params"], cfg, mesh, rep)
        assert_same_specs(jsh, sh, what + " params")
        assert rep == jrep, what + " report"
        for name in ("adamw", "adafactor"):
            assert_same_specs(jshd.opt_shardings(jsh, ref["params"], ref[name]),
                              shd.opt_shardings(sh, port["params"], port[name]),
                              f"{what} {name}")
        batch = {"tokens": torch.empty(INPUT, dtype=torch.int32, device="meta"),
                 "frames": torch.empty(INPUT + (7,), device="meta")}
        jbatch = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32) for k, v in batch.items()}
        for odd in (False, True):  # a batch the data axes divide, and one they do not
            if odd:
                batch = {k: torch.empty((3,) + tuple(v.shape[1:]), device="meta")
                         for k, v in batch.items()}
                jbatch = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32)
                          for k, v in batch.items()}
            want = jshd.input_shardings(jmesh, jbatch, jcfg)
            got = shd.input_shardings(mesh, batch, cfg)
            assert {k: trimmed(v.spec) for k, v in want.items()} == {
                k: v.spec for k, v in got.items()}, what + " inputs"
        if "cache" in port:
            assert_same_specs(jshd.cache_shardings(ref["cache"], jcfg, jmesh),
                              shd.cache_shardings(port["cache"], cfg, mesh), what + " cache")


def test_lanes_and_batch_specs_match_reference():
    jmesh, mesh = jax.sharding.AbstractMesh((4,), ("lanes",)), AbstractMesh((4,), ("lanes",))
    for extra in range(4):
        assert shd.lanes_spec(extra) == trimmed(jshd.lanes_spec(extra))
    tree = {"a": torch.empty(4, 8, device="meta"), "b": torch.empty(4, device="meta")}
    jtree = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.int32) for k, v in tree.items()}
    assert_same_specs(jshd.lanes_shardings(jmesh, jtree), shd.lanes_shardings(mesh, tree),
                      "lanes")
    for shape, axes in MESHES.values():
        jm, m = jax.sharding.AbstractMesh(shape, axes), AbstractMesh(shape, axes)
        for b in (1, 2, 3, 8, 64, 512):
            for extra in (0, 1, 2):
                for all_axes in (False, True):
                    assert shd.batch_spec(m, b, extra, all_axes) == trimmed(
                        jshd.batch_spec(jm, b, extra, all_axes)), (shape, b, extra, all_axes)


def test_local_slices_cover_every_leaf_once():
    """The blocks of a leaf over every mesh point tile it exactly, a dim
    over (pod, data) split pod-major."""
    mesh = AbstractMesh((2, 2, 3), ("pod", "data", "model"))
    shape, spec = (8, 6, 5), (("pod", "data"), "model")
    seen = np.zeros(shape, int)
    for p in range(2):
        for d in range(2):
            for m in range(3):
                block = shd.local_slices(shape, spec, mesh, {"pod": p, "data": d, "model": m})
                assert block[0] == slice(4 * p + 2 * d, 4 * p + 2 * d + 2)
                seen[block] += 1
    assert (seen == 1).all()
    assert shd.local_shape(shape, spec, mesh) == (2, 2, 5)
    assert shd.shard_factor(spec, mesh) == 12
    # as DTensor placements: each mesh dim shards the tensor dim it splits
    from torch.distributed.tensor import Replicate, Shard

    assert shd.placements(spec, mesh) == [Shard(0), Shard(0), Shard(1)]
    assert shd.placements((None, "model"), mesh) == [Replicate(), Replicate(), Shard(1)]


# ---------------------------------------------------------------- activation constraints

ACT_ARCHS = ["qwen3-0.6b", "xlstm-1.3b", "llama-3.2-vision-90b"]


def ref_act_sequence(monkeypatch, jcfg, jparams, batch, mesh):
    specs, seq = [], []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, sharding: specs.append(trimmed(sharding.spec)) or x)
    original = jact.shard_act

    def recording(x, *names):
        n = len(specs)
        y = original(x, *names)
        if len(specs) > n:
            seq.append((tuple(names), specs[-1]))
        return y

    for mod in (jlayers, jrecurrent, jtransformer):
        monkeypatch.setattr(mod, "shard_act", recording)
    with jact.use_act_sharding(mesh, jcfg):
        jax.eval_shape(lambda p, b: jtransformer.forward_train(p, jcfg, b), jparams, batch)
    return seq


@pytest.mark.parametrize("arch", ACT_ARCHS)
def test_shard_act_sequence_matches_reference(monkeypatch, arch):
    jcfg = jreduced_config(jget_config(arch)).replace(use_pallas=True, scan_layers=False,
                                                           remat="none")
    cfg = reduced_config(get_config(arch))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)}
    if cfg.num_image_tokens:
        batch["vision"] = rng.standard_normal((2, cfg.num_image_tokens, cfg.d_model)).astype(
            np.float32)
    jparams = jax.eval_shape(lambda: JLM(jcfg).init(jax.random.PRNGKey(0)))
    shape, axes = MESHES["2x4"]
    want = ref_act_sequence(monkeypatch, jcfg, jparams, {k: jnp.asarray(v) for k, v in
                                                         batch.items()},
                            jax.sharding.AbstractMesh(shape, axes))
    params = lm_mod.LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    with act.use_act_sharding(AbstractMesh(shape, axes), cfg), act.record_act() as got:
        lm_mod.forward_train(params, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert len(want) > 4 and got == want


def test_shard_act_checks_rank_and_local_batch():
    mesh = AbstractMesh((2, 4), ("data", "model"))
    x = torch.zeros(4, 3)
    with act.use_act_sharding(mesh), act.record_act() as seen:
        assert act.shard_act(x, "batch", "heads") is x
        with pytest.raises(ValueError, match="2 names for a 3-d"):
            act.shard_act(torch.zeros(1, 2, 3), "batch", None)
    assert seen == [(("batch", "heads"), ("data",))]
    assert act.rules_for(get_config("qwen3-0.6b").replace(moe_dp_attention=True)) == \
        jact.rules_for(jget_config("qwen3-0.6b").replace(moe_dp_attention=True))
    assert act.rules_for() == jact.rules_for()
    # a forward records nothing outside a mesh, or on a mesh of one point
    cfg = reduced_config(get_config(ACT_ARCHS[0]))
    params = lm_mod.LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.zeros(2, 8, dtype=torch.int32)}
    with act.record_act() as none:
        lm_mod.forward_train(params, cfg, batch)
        with act.use_act_sharding(AbstractMesh((1, 1), ("data", "model")), cfg):
            lm_mod.forward_train(params, cfg, batch)
    assert none == []
