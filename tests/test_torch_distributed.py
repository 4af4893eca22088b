"""The port's distribution layer on one gloo world of 8 CPU ranks, started
once for the module (``tests/test_torch_dist_worker.py`` holds the rank bodies;
the ranks import no JAX), against the JAX package and the port's own
unsharded step in this process:

  * ``compressed_psum_with_feedback`` over an 8-way axis: each rank's
    residual bit for bit with the reference's ``encode_int8``/``decode_int8``
    on that rank's inputs, the reduced gradient within 1e-6 of max|g| of the
    numpy mean of the reference's payloads (the sum's order differs);
  * GPipe on ``tests/test_multidevice.py``'s case (L 8, D 16, 6 microbatches,
    4 stages) within 1e-5 of the reference's sequential result;
  * the sharded train step of reduced qwen3-0.6b (fsdp) on a (2, 4) mesh:
    gradients within 1e-5 of each leaf's max|grad| of the port's unsharded
    step (held to ``jax.value_and_grad`` in ``test_torch_train.py``), loss
    within 1e-3 and parameters within 5e-3 (the reference test's limits),
    under AdamW and Adafactor; each rank holding its blocks' bytes alone;
  * elastic restore of one-device checkpoints (the port's, with optimizer
    state, and one written by the reference's ``CheckpointManager``) onto a
    (4, 2) mesh, each rank's blocks bit for bit;
  * ``Trainer(mesh=)``: two steps on the (2, 4) mesh with a checkpoint each
    (each rank writing its blocks), its losses within 1e-3 of the unsharded
    ``Trainer``'s, the last checkpoint read whole holding every rank's
    blocks, and a restart that restores every rank's blocks bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_dist_worker as worker
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced_config
from repro.distributed.compression import decode_int8, encode_int8
from repro.models import LM as JLM
from repro_torch.checkpoint import CheckpointManager
from repro_torch.common.tree import tree_items, tree_leaves
from repro_torch.distributed.comm import run_world
from repro_torch.train.steps import grads_of, make_train_step

WORLD = 8
BATCH, SEQ = 8, 32


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(0)
    inp = {
        "g": rng.standard_normal((WORLD, 64)).astype(np.float32),
        "e": (0.01 * rng.standard_normal((WORLD, 64))).astype(np.float32),
        "ws": (0.3 * rng.standard_normal((8, 16, 16))).astype(np.float32),
        "xs": rng.standard_normal((6, 4, 16)).astype(np.float32),
        "batch": {"tokens": rng.integers(0, 256, (BATCH, SEQ)).astype(np.int32),
                  "labels": rng.integers(0, 256, (BATCH, SEQ)).astype(np.int32)},
    }
    # a one-device checkpoint of the port: parameters and AdamW state after a step
    cfg, params, opt = worker.train_setup("adamw")
    cfg = cfg.replace(fsdp=False)
    opt_state = opt.init(params)
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    params, opt_state, _ = make_train_step(cfg, opt)(params, opt_state, 0, batch)
    inp["port_ckpt"] = str(tmp_path_factory.mktemp("port_ckpt"))
    CheckpointManager(inp["port_ckpt"], async_writes=False).save(
        {"params": params, "opt": opt_state}, 1, extra={"next_step": 1})
    # and one of the reference, as its own elastic-restore test writes it
    jcfg = jreduced_config(jget_config(worker.TRAIN_ARCH))
    jparams = JLM(jcfg).init(jax.random.PRNGKey(0))
    inp["ref_ckpt"] = str(tmp_path_factory.mktemp("ref_ckpt"))
    JCheckpointManager(inp["ref_ckpt"], keep=2, async_writes=False).save(
        {"params": jparams}, 1, extra={"next_step": 1})
    saved = {"port": {k: v for k, v in tree_items({"params": params, "opt": opt_state})},
             "ref": {k: torch.from_numpy(np.asarray(v))
                     for k, v in tree_items({"params": jax.device_get(jparams)})}}
    inp["trainer_ckpt"] = str(tmp_path_factory.mktemp("trainer_ckpt"))
    ranks = run_world(worker.run_all, WORLD, inp, device_type="cpu", all_ranks=True,
                      out_dir=str(tmp_path_factory.mktemp("ranks")))
    return inp, ranks, saved


def test_compressed_psum_matches_reference(world):
    inp, ranks, _ = world
    payloads = []
    for r, out in enumerate(ranks):
        gf = jnp.asarray(inp["g"][r]) + jnp.asarray(inp["e"][r])
        deq = decode_int8(encode_int8(gf))
        payloads.append(np.asarray(deq))
        red, new_e = out["psum"]
        np.testing.assert_array_equal(new_e.numpy(), np.asarray(gf - deq), err_msg=f"rank {r}")
    want = np.mean(payloads, axis=0)
    for r, out in enumerate(ranks):
        red = out["psum"][0].numpy()
        assert np.abs(red - want).max() <= 1e-6 * np.abs(inp["g"]).max(), r
        np.testing.assert_array_equal(red, ranks[0]["psum"][0].numpy())


def test_gpipe_matches_reference_sequential(world):
    inp, ranks, _ = world
    ref = jnp.asarray(inp["xs"])
    for i in range(inp["ws"].shape[0]):
        ref = jnp.tanh(ref @ jnp.asarray(inp["ws"][i]))
    for r, out in enumerate(ranks):
        err = float(np.abs(out["gpipe"].numpy() - np.asarray(ref)).max())
        assert err < 1e-5, (r, err)


def _unsharded(optimizer: str, batch: dict):
    cfg, params, opt = worker.train_setup(optimizer)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads, metrics = grads_of(params, cfg, b)
    params, _, _ = make_train_step(cfg, opt)(params, opt.init(params), 0, b)
    return grads, metrics, params


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_sharded_step_matches_unsharded(world, optimizer):
    inp, ranks, _ = world
    grads, metrics, params = _unsharded(optimizer, inp["batch"])
    for r, rank in enumerate(ranks):
        out = rank[optimizer]
        # the gradients do not depend on the optimizer: the ranks take them once
        for (key, want), got in zip(tree_items(grads), tree_leaves(rank["adamw"]["grads"])):
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            assert err <= 1e-5 * scale, (r, key, err, scale)
        assert abs(float(rank["adamw"]["metrics"]["loss"]) - float(metrics["loss"])) < 1e-3
        assert abs(float(out["step_metrics"]["loss"]) - float(metrics["loss"])) < 1e-3
        err = max(float((a - b).abs().max())
                  for a, b in zip(tree_leaves(params), tree_leaves(out["params"])))
        assert err < 5e-3, (r, err)


def test_sharded_ranks_hold_only_their_blocks(world):
    _, ranks, _ = world
    for r, rank in enumerate(ranks):
        for optimizer in ("adamw", "adafactor"):
            held, blocks, whole = rank[optimizer]["bytes"]
            assert held == blocks < whole, (r, optimizer, held, blocks, whole)


@pytest.mark.parametrize("which", ["port", "ref"])
def test_elastic_restore_onto_mesh_bit_for_bit(world, which):
    _, ranks, saved = world
    for r, rank in enumerate(ranks):
        out = rank[f"restore_{which}"]
        assert out["step"] == 1
        assert set(out["blocks"]) == set(saved[which])
        for key, (block, where) in out["blocks"].items():
            want = saved[which][key][where]
            assert block.dtype == want.dtype and torch.equal(block, want), (r, key)
    # the (4, 2) mesh really cuts the head over model and nothing is whole twice
    shapes = {tuple(rank["restore_ref"]["blocks"]["['params']['lm_head']"][0].shape)
              for rank in ranks}
    assert shapes == {(64, 128)}, shapes


def test_trainer_on_mesh_checkpoints_and_restarts(world, tmp_path):
    from repro_torch.data.tokens import TokenPipelineConfig
    from repro_torch.train.loop import Trainer, TrainLoopConfig

    from repro_torch.checkpoint.manager import load_pytree

    inp, ranks, _ = world
    cfg, _, _ = worker.train_setup("adamw")
    loop = TrainLoopConfig(total_steps=2, checkpoint_every=10**9, checkpoint_dir=str(tmp_path),
                           warmup_steps=1, log_every=10**9, async_checkpoints=False)
    data = TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=8)
    plain = Trainer(cfg, loop, data, device="cpu")
    want = plain.run()["history"]
    # the mesh's last checkpoint, read whole on one device, holds every rank's blocks
    abstract = plain.model.abstract_params()
    saved, extra = load_pytree(f"{inp['trainer_ckpt']}/step_00000002",
                               {"params": abstract, "opt": plain.optimizer.init(abstract)},
                               device="cpu")
    saved = dict(tree_items(saved))
    assert extra["next_step"] == 2
    for r, rank in enumerate(ranks):
        out = rank["trainer"]
        assert len(out["history"]) == 2
        assert max(abs(a - b) for a, b in zip(out["history"], want)) < 1e-3, (r, want)
        blocks = tree_items({"params": out["params"], "opt": out["opt"]})
        assert [key for key, _ in blocks] == list(out["slices"]) == list(saved)
        for key, block in blocks:
            assert torch.equal(block, saved[key][out["slices"][key]]), (r, key)
        params, opt_state, step = out["restored"]
        assert step == 2
        for a, b in zip(tree_leaves((out["params"], out["opt"])), tree_leaves((params,
                                                                               opt_state))):
            assert torch.equal(a, b), r
