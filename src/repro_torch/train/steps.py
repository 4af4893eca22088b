"""The train and eval steps (the reference's ``train/steps.py``): the loss
and its gradient, optional microbatched accumulation and int8 gradient
compression, global-norm clipping and the optimizer update.

The reference jits ``value_and_grad`` of its loss; the port runs the loss
eagerly and takes the gradient with autograd, through the engine kernels'
and the attention's backward (``router.EngineMatmul``,
``layers.TrainAttention``).  Nothing in a step waits for the device: the
metrics stay 0-d tensors on it.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.compression import compress_tree, decompress_tree
from repro_torch.models.transformer import loss_fn
from repro_torch.optim import Optimizer, clip_by_global_norm

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
