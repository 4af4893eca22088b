"""RoutePlan — the single source of truth for matmul placement: the port's
copy of ``repro/runtime/plan.py``.

A :class:`RoutePlan` records, per matmul of a layer stack, the shape and the
router's :class:`Route` decision under one :class:`RuntimeConfig`.  The same
plan drives ``collaborative_forward`` (which executes a plan's routes instead
of re-deriving them), the analytical FPGA cycle model
(``OctopusCycleModel.stack_report``) and the placement report
:meth:`RoutePlan.explain`.

Plans are built from explicit layer shapes::

    plan = RoutePlan.from_layers(usecase2_layers(1000))

or by tracing a callable on ``meta`` tensors, the counterpart of
``jax.eval_shape``: every ``router.matmul`` along the way records its
decision, and nothing is computed or launched::

    plan = RoutePlan.trace(lambda p, x: cnn_apply(p, x, config=cfg), params,
                           torch.empty(1000, 20), config=cfg)
    print(plan.explain())
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.runtime import routing
from repro_torch.runtime.config import RuntimeConfig


@dataclass(frozen=True)
class PlannedMatmul:
    name: str
    m: int
    k: int
    n: int
    route: routing.Route
    quantized: bool = False

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.m, self.k, self.n)

    @property
    def engine(self) -> str:
        return self.route.path

    @property
    def macs(self) -> int:
        return self.m * self.k * self.n


def _to_meta(tree: Any) -> Any:
    """Every tensor of ``tree`` (nested dicts, lists and tuples) as an empty
    ``meta`` tensor of the same shape and dtype; anything else unchanged."""
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_meta(v) for v in tree)
    return tree


@dataclass(frozen=True)
class RoutePlan:
    """An ordered, immutable placement plan for a stack of matmuls."""

    config: RuntimeConfig
    steps: Tuple[PlannedMatmul, ...]

    # --------------------------------------------------------- constructors
    @classmethod
    def from_layers(cls, layers: Sequence[Tuple[str, int, int, int]],
                    *, config: Optional[RuntimeConfig] = None) -> "RoutePlan":
        """Build a plan from explicit ``(name, M, K, N)`` layer shapes.  Its
        executor (``collaborative_forward``) runs every AryPE step unfused
        under ``fused_aggregation=False``, and the recorded routes say so."""
        cfg = config if config is not None else RuntimeConfig()
        steps = tuple(
            PlannedMatmul(name, m, k, n,
                          routing.route_matmul(m, k, n, config=cfg,
                                               unfused=not cfg.fused_aggregation),
                          bool(cfg.quantize and cfg.quant_scales is not None
                               and cfg.quant_scales.lookup(name) is not None))
            for name, m, k, n in layers
        )
        return cls(cfg, steps)

    @classmethod
    def trace(cls, fn: Callable, *args: Any, config: Optional[RuntimeConfig] = None,
              **kwargs: Any) -> "RoutePlan":
        """Run ``fn(*args, **kwargs)`` with every tensor argument moved to the
        ``meta`` device and record every routed matmul it performs.  The port
        has no ambient runtime: ``fn`` routes under the config it passes
        itself, and ``config`` is the one the plan reports."""
        cfg = config if config is not None else RuntimeConfig()
        with routing.record_routes() as records:
            fn(*_to_meta(args), **_to_meta(kwargs))
        steps = tuple(
            PlannedMatmul(r.name or f"mm{i}", r.m, r.k, r.n, r.route, r.quantized)
            for i, r in enumerate(records)
        )
        return cls(cfg, steps)

    # -------------------------------------------------------------- queries
    def __len__(self) -> int:
        return len(self.steps)

    def __iter__(self):
        return iter(self.steps)

    def layers(self) -> List[Tuple[str, int, int, int]]:
        return [(s.name, s.m, s.k, s.n) for s in self.steps]

    def engines(self) -> Dict[str, str]:
        """``{step name: engine}`` placement map."""
        return {s.name: s.engine for s in self.steps}

    def scoped(self, prefix: str, *, strip: bool = False) -> "RoutePlan":
        """The sub-plan of steps recorded under ``name_scope(prefix)``, same
        config.  With ``strip`` the scope prefix is removed from the step
        names, so the sub-plan reads as if the sub-model was traced alone."""
        p = prefix.rstrip("/") + "/"
        steps = tuple(s for s in self.steps if s.name.startswith(p))
        if strip:
            steps = tuple(replace(s, name=s.name[len(p):]) for s in steps)
        return RoutePlan(self.config, steps)

    def macs(self, engine: Optional[str] = None) -> int:
        return sum(s.macs for s in self.steps if engine is None or s.engine == engine)

    # -------------------------------------------------------------- report
    def explain(self) -> str:
        """Human-readable placement report, the reference's text (with a
        ``[calibrated: ...]`` tag for thresholds from a measured crossover)."""
        cfg = self.config
        head = (f"RoutePlan: {len(self.steps)} matmuls | policy={cfg.policy} "
                f"tau={cfg.tau} mxu_tile={cfg.mxu_tile} fill_depth={cfg.fill_depth}")
        if cfg.calibration:
            head += f" [calibrated: {cfg.calibration}]"
        if cfg.quantize and cfg.quant_scales is not None:
            head += f" [quantize: {cfg.quant_scales.fingerprint}]"
        if not self.steps:
            return head + "\n  (empty)"
        name_w = max(len(s.name) for s in self.steps)
        shape_w = max(len(f"({s.m},{s.k},{s.n})") for s in self.steps)
        lines = [head]
        for s in self.steps:
            shape = f"({s.m},{s.k},{s.n})"
            dtype = "int8" if s.quantized else "f32"
            lines.append(f"  {s.name:<{name_w}}  {shape:<{shape_w}}  "
                         f"{s.engine:<5}  {dtype:<4}  util={s.route.util:6.3f}  "
                         f"{s.route.reason}")
        total = self.macs() or 1
        ary, vpe = self.macs("arype"), self.macs("vpe")
        n_ary = sum(1 for s in self.steps if s.engine == "arype")
        n_q = sum(1 for s in self.steps if s.quantized)
        lines.append(f"  -- arype: {n_ary} matmuls ({100 * ary / total:.1f}% of MACs) | "
                     f"vpe: {len(self.steps) - n_ary} matmuls ({100 * vpe / total:.1f}% of MACs)")
        if n_q:
            lines.append(f"  -- int8: {n_q}/{len(self.steps)} matmuls quantized")
        return "\n".join(lines)
