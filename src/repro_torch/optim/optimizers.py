"""Optimizers over a tree of parameters (the reference's
``optim/optimizers.py``): AdamW, Adafactor (a factored second moment), SGD
with momentum, global-norm clipping and the cosine schedule.

States keep the reference's structure, which the checkpoint format names
leaf by leaf: ``AdamState(mu, nu)``, ``FactoredState(vr, vc)`` (a 0-d
``vc`` for leaves under 2-D) and SGD's tree of momenta, each leaf f32.

The arithmetic is f32 in the reference's order of operations, one rounding
an op: Python constants meet f32 tensors as f32 (as JAX's weak types do),
and the schedule, the bias corrections and Adafactor's decay are f32 values
computed from the step (``lr_t``, ``b1 ** step`` as Python doubles would
differ in the last bit).  ``update`` writes the parameters and the state in
place under ``torch.no_grad()`` and returns them; parameters keep their
dtype.

``update`` takes an optional tree of reducers like ``params``: Adafactor
takes every mean through its leaf's reducer, so a sharded step
(:func:`repro_torch.train.steps.make_sharded_train_step`) sums over the
ranks that hold the other blocks of a leaf; without one a mean is the
leaf's own (:data:`PLAIN`).
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from repro_torch.common.tree import tree_leaves, tree_map

Schedule = Callable[[int], torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]
    # update(grads, state, params, step, reducers=None) -> (params, state)


class Reducer:
    """The means of one leaf's statistics.  ``pdim`` names the parameter
    dim a mean runs over (a sharded step sums it over that dim's ranks)."""

    def mean(self, t: torch.Tensor, dim: int, pdim: int, keepdim: bool = False) -> torch.Tensor:
        return t.mean(dim=dim, keepdim=keepdim)

    def mean_all(self, t: torch.Tensor) -> torch.Tensor:
        return torch.mean(t)


PLAIN = Reducer()


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def cosine_schedule(base_lr: float, warmup: int, total: int, min_ratio: float = 0.1
                    ) -> Schedule:
    """step -> the learning rate, a 0-d f32 tensor on the CPU: linear warmup
    over ``warmup`` steps, then a cosine from ``base_lr`` down to
    ``min_ratio * base_lr`` at ``total``."""
    def lr(step) -> torch.Tensor:
        step = _f32(step)
        warm = _f32(base_lr) * torch.clamp_max(step / _f32(max(warmup, 1)), 1.0)
        frac = torch.clamp((step - _f32(warmup)) / _f32(max(total - warmup, 1)), 0.0, 1.0)
        cos = _f32(base_lr) * (_f32(min_ratio) + _f32((1 - min_ratio) * 0.5)
                               * (1 + torch.cos(_f32(math.pi) * frac)))
        return torch.where(step < warmup, warm, cos)

    return lr


def _lr_fn(lr: Union[Schedule, float]) -> Schedule:
    return lr if callable(lr) else (lambda _: _f32(lr))


def _scalar(t: torch.Tensor) -> float:
    """A 0-d f32 value as the Python float that holds it exactly: it meets an
    f32 tensor as that same f32 value."""
    return float(t.float())


def clip_by_global_norm(grads: Any, max_norm: float, *,
                        sq_sum: Optional[Callable[[Any], torch.Tensor]] = None
                        ) -> tuple[Any, torch.Tensor]:
    """Every gradient scaled by ``min(1, max_norm / max(norm, 1e-9))``, the
    norm over all leaves in f32 (each leaf's sum of squares, added in leaf
    order; ``sq_sum(grads)`` in its place, where the leaves are blocks of
    sharded ones).  Returns (grads, norm: a 0-d f32 tensor on the grads'
    device).  Nothing waits for the device."""
    total = (sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads))
             if sq_sum is None else sq_sum(grads))
    gnorm = torch.sqrt(total)
    scale = torch.clamp_max(max_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gnorm


# ---------------------------------------------------------------- AdamW


class AdamState(NamedTuple):
    mu: Any
    nu: Any


def _zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def adamw(lr: Union[Schedule, float], b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return AdamState(mu=tree_map(_zeros, params), nu=tree_map(_zeros, params))

    @torch.no_grad()
    def update(grads, state, params, step, reducers=None):
        stepf = _f32(step) + 1.0
        lr_t = _scalar(lr_fn(step))
        c1 = _scalar(1.0 - torch.pow(_f32(b1), stepf))
        c2 = _scalar(1.0 - torch.pow(_f32(b2), stepf))

        def upd(g, m, v, p):
            g = g.float()
            m.mul_(b1).add_(g * (1 - b1))  # b1 * m + (1 - b1) * g
            v.mul_(b2).add_(g * (1 - b2) * g)  # b2 * v + (1 - b2) * g * g
            delta = (m / c1).div_(torch.sqrt(v / c2).add_(eps)).add_(weight_decay * p.float())
            p.copy_(p.float() - lr_t * delta)

        tree_map(upd, grads, state.mu, state.nu, params)
        return params, state

    return Optimizer(init=init, update=update)


# ---------------------------------------------------------------- Adafactor


class FactoredState(NamedTuple):
    vr: Any  # row statistics (the whole second moment for leaves under 2-D)
    vc: Any  # column statistics (a 0-d zero for leaves under 2-D)


def adafactor(lr: Union[Schedule, float], eps: float = 1e-30, clip_threshold: float = 1.0,
              weight_decay: float = 0.0, decay: float = 0.8) -> Optimizer:
    """Adafactor without a first moment (beta1 = 0)."""
    lr_fn = _lr_fn(lr)

    def init(params):
        def vr(p):
            shape = p.shape[:-1] if p.dim() >= 2 else p.shape
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        def vc(p):
            shape = p.shape[:-2] + p.shape[-1:] if p.dim() >= 2 else ()
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        return FactoredState(vr=tree_map(vr, params), vc=tree_map(vc, params))

    @torch.no_grad()
    def update(grads, state, params, step, reducers=None):
        stepf = _f32(step) + 1.0
        beta2_t = 1.0 - torch.pow(stepf, _f32(-decay))
        beta2, one_minus = _scalar(beta2_t), _scalar(1.0 - beta2_t)
        lr_t = _scalar(lr_fn(step))

        def upd(g, vr, vc, p, red):
            g = g.float()
            g2 = g * g + eps
            if p.dim() >= 2:
                vr.copy_(beta2 * vr + one_minus * red.mean(g2, -1, -1))
                vc.copy_(beta2 * vc + one_minus * red.mean(g2, -2, -2))
                # vr's last dim is the parameter's dim -2
                rfac = torch.rsqrt(vr / torch.clamp_min(red.mean(vr, -1, -2, keepdim=True), eps))
                u = g * rfac[..., None] * torch.rsqrt(vc)[..., None, :]
            else:
                vr.copy_(beta2 * vr + one_minus * g2)
                u = g * torch.rsqrt(vr)
            rms = torch.sqrt(red.mean_all(torch.square(u)) + 1e-30)
            u = u / torch.clamp_min(rms / clip_threshold, 1.0)
            delta = u + weight_decay * p.float()
            p.copy_(p.float() - lr_t * delta)

        if reducers is None:
            reducers = tree_map(lambda _: PLAIN, params)
        tree_map(upd, grads, state.vr, state.vc, params, reducers)
        return params, state

    return Optimizer(init=init, update=update)


# ---------------------------------------------------------------- SGD + momentum


def sgd(lr: Union[Schedule, float], momentum: float = 0.9) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return tree_map(_zeros, params)

    @torch.no_grad()
    def update(grads, state, params, step, reducers=None):
        lr_t = _scalar(lr_fn(step))

        def upd(g, m, p):
            m.mul_(momentum).add_(g.float())
            p.copy_(p.float() - lr_t * m)

        tree_map(upd, grads, state, params)
        return params, state

    return Optimizer(init=init, update=update)


def make_optimizer(name: str, lr, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(lr, **kw)
    if name == "adafactor":
        return adafactor(lr, **kw)
    if name == "sgd":
        return sgd(lr, **kw)
    raise ValueError(f"unknown optimizer {name}")
