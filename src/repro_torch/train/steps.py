"""The train and eval steps (the reference's ``train/steps.py``): the loss
and its gradient, optional microbatched accumulation and int8 gradient
compression, global-norm clipping and the optimizer update; and the sharded
step on a mesh (:func:`make_sharded_train_step`), which the reference gets
from jitting the same step with ``in_shardings``.

The reference jits ``value_and_grad`` of its loss; the port runs the loss
eagerly and takes the gradient with autograd, through the engine kernels'
and the attention's backward (``router.EngineMatmul``,
``layers.TrainAttention``).  Nothing in a step waits for the device: the
metrics stay 0-d tensors on it.
"""
from __future__ import annotations

import math
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import comm
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.act import use_act_sharding
from repro_torch.distributed.compression import compress_tree, decompress_tree
from repro_torch.distributed.gather import GatherDict, regather_saved
from repro_torch.models.spec import abstract_params, map_specs
from repro_torch.models.transformer import loss_fn, model_specs
from repro_torch.optim import Optimizer, clip_by_global_norm
from repro_torch.optim.optimizers import AdamState, FactoredState, Reducer

METRICS = ("ce", "aux", "loss")


def grads_of(params: dict, cfg: ArchConfig, batch: dict) -> tuple[dict, dict]:
    """(the loss's gradient, a tree like ``params`` in their dtypes; the
    metrics, detached).  The parameters need not require grad: the loss
    runs on detached aliases of them that do (no copy)."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = loss_fn(live, cfg, batch)
    leaves = tree_leaves(live)
    flat = iter(torch.autograd.grad(loss, leaves))
    grads = tree_map(lambda _: next(flat), live)
    return grads, {k: metrics[k].detach() for k in METRICS}


def make_train_step(cfg: ArchConfig, optimizer: Optimizer, *, grad_clip: float = 1.0,
                    accum_steps: int = 1, compress_grads: bool = False) -> Callable:
    """Returns ``train_step(params, opt_state, step, batch) -> (params,
    opt_state, metrics)``; the optimizer updates ``params`` and
    ``opt_state`` in place.  With ``accum_steps`` > 1 the batch's leading
    axis splits into that many microbatches, run one after another: their
    f32 gradients and metrics summed in microbatch order and divided by
    ``accum_steps``, as the reference's scan.  ``metrics`` holds ``ce``,
    ``aux``, ``loss`` and ``grad_norm`` (the norm before clipping)."""

    def train_step(params, opt_state, step, batch):
        if accum_steps == 1:
            grads, metrics = grads_of(params, cfg, batch)
        else:
            def split(x):
                b = x.shape[0]
                if b % accum_steps:
                    raise ValueError(f"batch {b} does not split into {accum_steps} microbatches")
                return x.reshape(accum_steps, b // accum_steps, *x.shape[1:])

            micro = {k: split(v) for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            dev = tree_leaves(params)[0].device
            metrics = {k: torch.zeros((), dtype=torch.float32, device=dev) for k in METRICS}
            for i in range(accum_steps):
                g, m = grads_of(params, cfg, {k: v[i] for k, v in micro.items()})
                grads = tree_map(lambda a, b: a + b.float(), grads, g)
                metrics = {k: metrics[k] + m[k] for k in METRICS}
            grads = tree_map(lambda g: g / accum_steps, grads)
            metrics = {k: v / accum_steps for k, v in metrics.items()}
        if compress_grads:
            grads = decompress_tree(compress_tree(grads))
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        params, opt_state = optimizer.update(grads, opt_state, params, step)
        return params, opt_state, dict(metrics, grad_norm=gnorm)

    return train_step


def make_eval_step(cfg: ArchConfig) -> Callable:
    def eval_step(params, batch):
        with torch.no_grad():
            return loss_fn(params, cfg, batch)[1]

    return eval_step


# ---------------------------------------------------------------- the sharded step


class ShardReducer(Reducer):
    """Adafactor's means over one leaf's block: a mean over a sharded dim is
    the block's sum, summed over that dim's mesh axes, over the whole dim."""

    def __init__(self, spec: tuple, shape: tuple, mesh):
        self.spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        self.shape, self.mesh = tuple(shape), mesh

    def _axes(self, entries) -> tuple:
        axes = []
        for entry in entries:
            for a in ((entry,) if isinstance(entry, str) else (entry or ())):
                if a not in axes and comm.axis_size(self.mesh, a) > 1:
                    axes.append(a)
        return tuple(axes)

    def mean(self, t, dim, pdim, keepdim=False):
        axes = self._axes([self.spec[pdim]])
        if not axes:
            return t.mean(dim=dim, keepdim=keepdim)
        return comm.all_reduce(t.sum(dim=dim, keepdim=keepdim), axes, self.mesh) / self.shape[pdim]

    def mean_all(self, t):
        axes = self._axes(self.spec)
        if not axes:
            return torch.mean(t)
        return comm.all_reduce(torch.sum(t), axes, self.mesh) / math.prod(self.shape)


def train_shardings(cfg: ArchConfig, mesh, optimizer: Optimizer) -> tuple[Any, Any]:
    """(parameter shardings, optimizer-state shardings) of ``cfg`` on
    ``mesh`` by the rules, from the specs' shapes (no memory)."""
    specs = model_specs(cfg)
    abstract = abstract_params(specs)
    param_sh = shd.shardings_for(map_specs(lambda s: s.axes, specs), abstract, cfg, mesh)
    return param_sh, shd.opt_shardings(param_sh, abstract, optimizer.init(abstract))


def shard_tree(tree: Any, shardings: Any, mesh, device=None) -> Any:
    """This rank's block of every leaf of a whole tree (copies: the whole
    leaves may go)."""
    return tree_map(lambda t, sh: comm.block_of(t, sh.spec, mesh).to(
        device if device is not None else t.device).clone(), tree, shardings)


def gather_tree(tree: Any, shardings: Any, mesh) -> Any:
    """The whole tree from every rank's blocks (every rank gets it)."""
    return tree_map(lambda t, sh: comm.all_gather(t, sh.spec, mesh), tree, shardings)


def shard_batch(batch: dict, cfg: ArchConfig, mesh) -> dict:
    """This rank's rows of a global batch (over (pod, data), or every axis
    under ``moe_dp_attention``)."""
    sh = shd.input_shardings(mesh, batch, cfg)
    return {k: comm.block_of(v, sh[k].spec, mesh).contiguous() for k, v in batch.items()}


def _compute_shardings(opt_state: Any, param_sh: Any, shapes: Any) -> Any:
    """Where the update reads each optimizer leaf: in its parameter's
    layout (Adafactor's row statistics drop the last dim's entry, its
    column statistics the dim before; a 0-d column statistic replicated)."""
    def pad(sh, shape):
        return list(sh.spec) + [None] * (len(shape) - len(sh.spec))

    if isinstance(opt_state, AdamState):
        return AdamState(mu=param_sh, nu=param_sh)
    if isinstance(opt_state, FactoredState):
        vr = tree_map(lambda sh, s: shd.Sharding(sh.mesh, pad(sh, s)[:-1] if len(s) >= 2
                                                 else sh.spec), param_sh, shapes)
        vc = tree_map(lambda sh, s: shd.Sharding(sh.mesh, pad(sh, s)[:-2] + pad(sh, s)[-1:]
                                                 if len(s) >= 2 else ()), param_sh, shapes)
        return FactoredState(vr=vr, vc=vc)
    return param_sh  # SGD's momenta


def sharded_grads_of(params: dict, cfg: ArchConfig, batch: dict, mesh, param_sh: Any
                     ) -> tuple[dict, dict]:
    """:func:`grads_of` on a mesh: (this rank's blocks of the gradient, the
    mean over the ranks; the metrics, means over the ranks) from this
    rank's blocks of the parameters and its rows of the batch."""
    world = dist.get_world_size()
    rows = next(iter(batch.values())).shape[0]
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    with use_act_sharding(mesh, cfg, local_batch=rows), regather_saved():
        loss, metrics = loss_fn(GatherDict(live, tree_map(lambda sh: sh.spec, param_sh), mesh),
                                cfg, batch)
    flat = iter(torch.autograd.grad(loss, tree_leaves(live)))
    grads = tree_map(lambda _: next(flat), live)
    metrics = {k: metrics[k].detach() for k in METRICS}
    if world > 1:
        metrics = {k: comm.all_reduce(v.clone()) / world for k, v in metrics.items()}
    return grads, metrics


def make_sharded_train_step(cfg: ArchConfig, optimizer: Optimizer, mesh, param_sh: Any,
                            opt_sh: Any, *, grad_clip: float = 1.0) -> Callable:
    """The train step on a live ``DeviceMesh``, gather then compute.

    ``train_step(params, opt_state, step, batch) -> (params, opt_state,
    metrics)`` takes this rank's blocks of the parameters and optimizer
    state (laid out by ``param_sh`` and ``opt_sh``, :func:`train_shardings`)
    and its rows of the batch (:func:`shard_batch`).  The loss runs on
    whole leaves gathered at their use (:mod:`repro_torch.distributed.gather`),
    so every product runs the engine kernels on full local operands; each
    gradient comes back as the mean over the ranks, cut to this rank's
    block.  The clip's squared norm sums every leaf's block once over the
    world; the optimizer updates each rank's blocks (an optimizer leaf laid
    out unlike its parameter is moved into the parameter's layout and
    back; Adafactor's means sum over the ranks, :class:`ShardReducer`).
    The metrics are the means over the ranks.  With one rank every gather
    and reduction is the identity, and the step is :func:`make_train_step`'s
    bit for bit."""
    specs = model_specs(cfg)
    shapes = tree_map(lambda p: tuple(p.shape), abstract_params(specs))
    reducers = tree_map(lambda sh, s: ShardReducer(sh.spec, s, mesh), param_sh, shapes)
    opt_abstract = optimizer.init(abstract_params(specs))
    opt_shapes = tree_map(lambda t: tuple(t.shape), opt_abstract)
    comp_sh = _compute_shardings(opt_abstract, param_sh, shapes)
    sh_leaves = tree_leaves(param_sh)
    world = dist.get_world_size()

    def sq_sum(grads):
        parts = []
        for g, sh in zip(tree_leaves(grads), sh_leaves):
            t = torch.sum(torch.square(g.float()))
            copies = world // shd.shard_factor(sh.spec, mesh)  # ranks holding this block
            parts.append(t / copies if copies > 1 else t)
        return comm.all_reduce(sum(parts)) if world > 1 else sum(parts)

    def train_step(params, opt_state, step, batch):
        grads, metrics = sharded_grads_of(params, cfg, batch, mesh, param_sh)
        grads, gnorm = clip_by_global_norm(grads, grad_clip, sq_sum=sq_sum)
        work = tree_map(lambda t, src, dst, s: comm.relayout(t, s, src.spec, dst.spec, mesh),
                        opt_state, opt_sh, comp_sh, opt_shapes)
        params, work = optimizer.update(grads, work, params, step, reducers=reducers)
        tree_map(lambda t, new, src, dst, s: None if src.spec == dst.spec else t.copy_(
            comm.relayout(new, s, dst.spec, src.spec, mesh)), opt_state, work, opt_sh, comp_sh,
            opt_shapes)
        return params, opt_state, dict(metrics, grad_norm=gnorm)

    return train_step
