"""Rank bodies of the port's gloo worlds for ``tests/test_torch_distributed.py``
(no tests of its own).

Spawned ranks import this module, never JAX: the test holds what the ranks
return against the JAX package in the parent.  Every rank runs every case in
the same order (the collectives pair up across ranks) and returns a dict.
"""
import torch
from torch.distributed.device_mesh import init_device_mesh

TRAIN_ARCH = "qwen3-0.6b"
LR = 1e-2


def train_setup(optimizer: str):
    """Reduced qwen3-0.6b (fsdp on), its seeded port parameters on the CPU
    and the optimizer, as the parent builds them."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models.transformer import LM
    from repro_torch.optim import make_optimizer

    cfg = reduced_config(get_config(TRAIN_ARCH)).replace(fsdp=True, optimizer=optimizer)
    params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    return cfg, params, make_optimizer(optimizer, LR)


def _tree_bytes(tree) -> int:
    from repro_torch.common.tree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _sharded_step(mesh, optimizer_name: str, batch: dict, *, grads: bool) -> dict:
    """One sharded train step on ``mesh``: the gathered parameters and the
    step's metrics, the bytes this rank holds beside its blocks' sum, and
    with ``grads`` the gathered gradients and their metrics."""
    from repro_torch.common.tree import tree_leaves
    from repro_torch.distributed import sharding as shd
    from repro_torch.train import steps

    cfg, params, opt = train_setup(optimizer_name)
    param_sh, opt_sh = steps.train_shardings(cfg, mesh, opt)
    local = steps.shard_tree(params, param_sh, mesh)
    opt_local = steps.shard_tree(opt.init(params), opt_sh, mesh)
    rows = steps.shard_batch({k: torch.from_numpy(v) for k, v in batch.items()}, cfg, mesh)
    out = {}
    if grads:
        g, metrics = steps.sharded_grads_of(local, cfg, rows, mesh, param_sh)
        out = {"grads": steps.gather_tree(g, param_sh, mesh), "metrics": metrics}
    step = steps.make_sharded_train_step(cfg, opt, mesh, param_sh, opt_sh)
    local, opt_local, m = step(local, opt_local, 0, rows)
    out["step_metrics"] = m
    out["params"] = steps.gather_tree(local, param_sh, mesh)
    want = sum(t.numel() // shd.shard_factor(sh.spec, mesh) * t.element_size()
               for t, sh in zip(tree_leaves(params), tree_leaves(param_sh)))
    want += sum(t.numel() // shd.shard_factor(sh.spec, mesh) * t.element_size()
                for t, sh in zip(tree_leaves(opt.init(params)), tree_leaves(opt_sh)))
    out["bytes"] = (_tree_bytes(local) + _tree_bytes(opt_local), want,
                    _tree_bytes(params) + _tree_bytes(opt.init(params)))
    return out


def _restore(mesh, directory: str, with_opt: bool) -> dict:
    """Restore the latest checkpoint in ``directory`` onto ``mesh``: this
    rank's blocks and the slices they stand for, by leaf path."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.common.tree import tree_items
    from repro_torch.distributed.sharding import local_slices, mesh_coordinate
    from repro_torch.models.transformer import LM
    from repro_torch.train import steps

    cfg, _, opt = train_setup("adamw")
    cfg = cfg.replace(fsdp=False)  # the reference test's config
    abstract = LM(cfg, device="cpu").abstract_params()
    param_sh, opt_sh = steps.train_shardings(cfg, mesh, opt)
    like, sh = {"params": abstract}, {"params": param_sh}
    if with_opt:
        like["opt"], sh["opt"] = opt.init(abstract), opt_sh
    tree, extra, step = CheckpointManager(directory, async_writes=False).restore(
        like, shardings=sh, device="cpu")
    coord = mesh_coordinate(mesh)
    blocks = {}
    for (key, t), (_, s), (_, a) in zip(tree_items(tree), tree_items(sh), tree_items(like)):
        blocks[key] = (t, local_slices(tuple(a.shape), s.spec, mesh, coord))
    return {"blocks": blocks, "step": step}


def _trainer(mesh, directory: str) -> dict:
    """``Trainer.run`` on ``mesh`` for 2 steps with a checkpoint a step
    (each rank writing its blocks), then a new ``Trainer`` on the same
    directory restoring each rank's blocks: the losses, both runs' final
    blocks, and the slices the blocks stand for, by leaf path."""
    from repro_torch.common.tree import tree_items
    from repro_torch.data.tokens import TokenPipelineConfig
    from repro_torch.distributed.sharding import local_slices, mesh_coordinate
    from repro_torch.train.loop import Trainer, TrainLoopConfig

    cfg, _, _ = train_setup("adamw")
    loop = TrainLoopConfig(total_steps=2, checkpoint_every=1, checkpoint_dir=directory,
                           warmup_steps=1, log_every=10**9, async_checkpoints=False)
    data = TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=8)
    trainer = Trainer(cfg, loop, data, device="cpu", mesh=mesh)
    out = trainer.run()
    params, opt_state, step = Trainer(cfg, loop, data, device="cpu",
                                      mesh=mesh).restore_or_init()
    abstract = trainer.model.abstract_params()
    whole = {"params": abstract, "opt": trainer.optimizer.init(abstract)}
    sh, coord = trainer.shardings, mesh_coordinate(mesh)
    slices = {key: local_slices(tuple(a.shape), s.spec, mesh, coord)
              for (key, a), (_, s) in zip(tree_items(whole),
                                          tree_items({"params": sh["params"], "opt": sh["opt"]}))}
    return {"history": out["history"], "params": out["params"], "opt": out["opt_state"],
            "restored": (params, opt_state, step), "slices": slices}


def run_all(rank: int, world: int, inp: dict) -> dict:
    torch.set_num_threads(1)
    from repro_torch.distributed.compression import compressed_psum_with_feedback
    from repro_torch.distributed.pipeline import pipeline_forward, split_stages, stage_of
    from repro_torch.distributed.sharding import mesh_coordinate
    from repro_torch.launch.mesh import make_host_mesh

    out = {}
    # the compressed all-reduce over an 8-way data axis
    mesh8 = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    g, e = torch.from_numpy(inp["g"][rank]), torch.from_numpy(inp["e"][rank])
    red, new_e = compressed_psum_with_feedback({"g": g}, {"g": e}, "data", mesh8)
    out["psum"] = (red["g"], new_e["g"])

    # GPipe over the pod axis of a (4, 2) mesh: two pipelines side by side
    mesh_pp = init_device_mesh("cpu", (4, world // 4), mesh_dim_names=("pod", "data"))
    stages = split_stages({"w": torch.from_numpy(inp["ws"])}, 4)

    def stage_fn(w, x, stage_idx):
        for i in range(w.shape[0]):
            x = torch.tanh(x @ w[i])
        return x

    out["gpipe"] = pipeline_forward(stage_fn, stage_of(stages, mesh_coordinate(mesh_pp)["pod"])
                                    ["w"], torch.from_numpy(inp["xs"]), mesh=mesh_pp, axis="pod")

    # the sharded train step of reduced qwen3-0.6b (fsdp) on a (2, 4) mesh
    mesh = make_host_mesh(2, world // 2)
    out["adamw"] = _sharded_step(mesh, "adamw", inp["batch"], grads=True)
    out["adafactor"] = _sharded_step(mesh, "adafactor", inp["batch"], grads=False)

    # elastic restore of one-device checkpoints onto a (4, 2) mesh
    mesh42 = make_host_mesh(4, world // 4)
    out["restore_port"] = _restore(mesh42, inp["port_ckpt"], with_opt=True)
    out["restore_ref"] = _restore(mesh42, inp["ref_ckpt"], with_opt=False)

    # Trainer.run on the (2, 4) mesh, its checkpoints, and a restart from them
    out["trainer"] = _trainer(mesh, inp["trainer_ckpt"])
    return out
