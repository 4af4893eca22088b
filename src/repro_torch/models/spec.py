"""Declarative parameter specs (the reference's ``models/spec.py``): one
source of shapes and inits for a model's nested dict of parameters.

From a spec tree the port derives the materialized tensors
(:func:`init_params`, from an explicit ``torch.Generator``) and the abstract
shapes (:func:`abstract_params`, ``meta`` tensors: no memory).  The inits are
the reference's (fan-in scaled normal, small normal, zeros, ones); the random
numbers differ from JAX's, and tests carry JAX's weights across through
``convert.lm_params_from_numpy`` when they must match.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.common.util import Device, resolve_device


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]  # logical axis name per dim (None = replicated)
    init: str = "normal"  # normal|zeros|ones|small_normal
    scale: float = 1.0
    dtype: str = "float32"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def map_specs(fn: Callable[[ParamSpec], Any], specs: Any) -> Any:
    """``fn`` applied to every spec of a nested dict, keys in sorted order
    (JAX's pytree order), the nesting kept."""
    if isinstance(specs, ParamSpec):
        return fn(specs)
    return {k: map_specs(fn, specs[k]) for k in sorted(specs)}


def _materialize(spec: ParamSpec, generator: torch.Generator, device: torch.device
                 ) -> torch.Tensor:
    dtype = getattr(torch, spec.dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init == "normal":  # fan-in scaled
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale / np.sqrt(max(fan_in, 1))
    elif spec.init == "small_normal":
        std = 0.02 * spec.scale
    else:
        raise ValueError(f"unknown init {spec.init!r}")
    # scaled in place: a bf16 leaf then needs one f32 draw beside it, not two
    # (starcoder2-15b's stacked MLP leaf is 24 GB in f32)
    w = torch.randn(spec.shape, generator=generator, device=generator.device).mul_(std)
    return w.to(device=device, dtype=dtype)


def init_params(specs: Any, generator: torch.Generator, *, device: Device = None) -> Any:
    """Materialize a spec tree, leaf after leaf in sorted key order from
    ``generator`` (drawn on the generator's device, then moved to
    ``device``)."""
    dev = resolve_device(device)
    return map_specs(lambda s: _materialize(s, generator, dev), specs)


def abstract_params(specs: Any) -> Any:
    """The spec tree as empty ``meta`` tensors of the right shapes and types."""
    return map_specs(lambda s: torch.empty(s.shape, dtype=getattr(torch, s.dtype),
                                           device="meta"), specs)


def stack_specs(specs: Any, n: int, axis_name: Optional[str] = "layers") -> Any:
    """Add a leading stacking dim (the superblocks) to every spec."""
    return map_specs(lambda s: ParamSpec((n,) + s.shape, (axis_name,) + s.axes, s.init,
                                         s.scale, s.dtype), specs)
