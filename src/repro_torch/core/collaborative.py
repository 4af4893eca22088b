"""Heterogeneous collaborative computing (paper §3.2.3): the port of
``repro/core/collaborative.py``.

1. :func:`collaborative_forward` — execute a stack of matmul layers with the
   router's placement (small layers on the VPE, large on the AryPE, block
   aggregation fused), following a :class:`RoutePlan` built once per stack
   or passed in.  ``RuntimeConfig.fused_aggregation=False`` is the paper's
   "wo/ collaborating" ablation (Table 6): every AryPE-placed matmul writes
   its K-block partials to memory and sums them in a separate pass, through
   the ``mm_unfused_partials`` kernel on the card (:func:`_unfused`).

2. :class:`OctopusCycleModel` — the reference's analytical model of the
   paper's FPGA (16x16 AryPE, 8-lane x 2-sublane SIMDU, 8-unit VU, 222 MHz,
   dual 16-byte memory channels), copied unchanged.  Its cycles and times
   are the FPGA's, never the card's.  :meth:`OctopusCycleModel.stack_report`
   costs the same :class:`RoutePlan` that the execution path runs.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Union

import torch

from repro_torch.common.util import ceil_div
from repro_torch.core import router
from repro_torch.kernels.arype_matmul.ops import arype_matmul_unfused
from repro_torch.runtime.config import RuntimeConfig
from repro_torch.runtime.plan import RoutePlan

UNFUSED_BK = 32  # the paper's 32x32 blocking (§3.2.3), as the reference's _unfused_jnp


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MatmulLayer:
    w_name: str
    activation: Optional[str] = None


def plan_stack(x: torch.Tensor, weights: Sequence[torch.Tensor], *,
               config: Optional[RuntimeConfig] = None,
               names: Optional[Sequence[str]] = None) -> RoutePlan:
    """Route a stack of matmul layers once: the (batch*M) stream length is
    invariant through the stack, K/N follow the weight shapes."""
    m_eff = math.prod(x.shape[:-1])
    layers = []
    for i, w in enumerate(weights):
        name = names[i] if names is not None else f"layer{i}"
        layers.append((name, m_eff, int(w.shape[0]), int(w.shape[1])))
    return RoutePlan.from_layers(layers, config=config)


def collaborative_forward(x: torch.Tensor, weights: Sequence[torch.Tensor],
                          activations: Sequence[Optional[str]], *,
                          config: Optional[RuntimeConfig] = None,
                          plan: Optional[RoutePlan] = None) -> torch.Tensor:
    """Run x through a stack of routed matmuls, executing ``plan`` (built here
    when not supplied).  A supplied plan's own config governs execution
    unless ``config=`` overrides it."""
    if config is None and plan is not None:
        config = plan.config
    cfg = config if config is not None else RuntimeConfig()
    if plan is None:
        plan = plan_stack(x, weights, config=cfg)
    else:
        if len(plan.steps) != len(weights):
            raise ValueError(
                f"plan has {len(plan.steps)} steps but the stack has "
                f"{len(weights)} layers — rebuild the plan for this stack")
        m_eff = math.prod(x.shape[:-1])
        for step, w in zip(plan.steps, weights):
            if (step.m, step.k, step.n) != (m_eff, int(w.shape[0]), int(w.shape[1])):
                raise ValueError(
                    f"plan step {step.name!r} was routed for shape "
                    f"({step.m},{step.k},{step.n}) but the stack executes "
                    f"({m_eff},{int(w.shape[0])},{int(w.shape[1])}) — a stale "
                    "plan would silently diverge from the router; rebuild it")
    h = x
    for step, w, act in zip(plan.steps, weights, activations):
        if not cfg.fused_aggregation and step.engine == "arype":
            h = _unfused(h, w, act)
        else:
            h = router.matmul(h, w, activation=act, route=step.route, config=cfg)
    return h


def _unfused(x: torch.Tensor, w: torch.Tensor, act: Optional[str],
             bk: int = UNFUSED_BK) -> torch.Tensor:
    """The ablation's AryPE matmul, counterpart of the reference's
    ``_unfused_jnp``: K blocks of ``bk`` (32, the paper's blocking; a
    128-deep block would absorb every paper K in one partial), each block's
    f32 partial written to memory, then summed in block order and activated.
    Always f32: the reference never quantizes the unfused path."""
    *batch, k = x.shape
    out = arype_matmul_unfused(x.reshape(-1, k).contiguous(), w.contiguous(),
                               activation=act or "none", bk=bk)
    return out.reshape(*batch, w.shape[1])


# ---------------------------------------------------------------------------
# Analytical FPGA cycle model (validates the paper's own numbers)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class OctopusHW:
    """Paper §4.1 implementation parameters."""

    array_k: int = 16  # AryPE systolic array is 16x16
    clock_hz: float = 222e6  # computing-domain clock
    simd_lanes: int = 8  # SIMDU lanes
    sublanes: int = 2  # sub-lanes per lane
    mults_per_sublane: int = 4  # 4-wide vector product per sub-lane
    vu_units: int = 8  # VU parallel adder/mult units
    mem_channels: int = 2  # dual memory channels
    bytes_per_cycle: int = 16  # 128-bit channel width


@dataclass
class LayerCost:
    name: str
    mk_n: tuple[int, int, int]
    engine: str
    compute_cycles: float
    stall_cycles: float
    mem_cycles: float
    useful_macs: float

    @property
    def total_cycles(self) -> float:
        return max(self.compute_cycles + self.stall_cycles, self.mem_cycles)


class OctopusCycleModel:
    """Cycle model for a stack of (M,K)x(K,N) layers on the Octopus FPGA.

    AryPE: an (M,K)x(K,N) matmul is blocked into ceil(K/k)*ceil(N/k) passes of
    (M,k)x(k,k); each pass streams M rows plus 2k fill/drain cycles.  Without
    collaboration, each extra K-block costs an aggregation stall of M rows per
    N-block (the array is idle while partial blocks are added).  Data movement
    uses the dual 16-byte channels (int8 operands).

    VPE/SIMDU: 8 lanes x 2 sublanes x 4 mults = 64 MACs/cycle.
    VU: 8 adds/cycle (aggregation offload in collaborative mode).
    """

    def __init__(self, hw: OctopusHW = OctopusHW()):
        self.hw = hw

    def matmul_cost(self, m: int, k: int, n: int, engine: str, collaborative: bool) -> LayerCost:
        hw = self.hw
        macs = float(m) * k * n
        if engine == "vpe":
            mults = hw.simd_lanes * hw.sublanes * hw.mults_per_sublane
            compute = macs / mults
            mem = (m * k + k * n + m * n) / (hw.mem_channels * hw.bytes_per_cycle)
            return LayerCost("vpe", (m, k, n), "vpe", compute, 0.0, mem, macs)
        kb = ceil_div(k, hw.array_k)
        nb = ceil_div(n, hw.array_k)
        compute = kb * nb * (m + 2 * hw.array_k)
        stall = 0.0 if collaborative else (kb - 1) * nb * m  # aggregation stalls the array
        # operands stream per pass: activations (m x k-block) per N-block + weights
        bytes_moved = nb * (m * min(k, hw.array_k) * kb) + k * n + m * n * 4  # int8 in, fp32 partials out
        mem = bytes_moved / (hw.mem_channels * hw.bytes_per_cycle)
        return LayerCost("arype", (m, k, n), "arype", compute, stall, mem, macs)

    def stack_report(self, plan: Union[RoutePlan, Sequence[tuple[str, int, int, int]]], *,
                     collaborative: bool, config: Optional[RuntimeConfig] = None) -> dict:
        """Cost a placement plan.  ``plan`` is a :class:`RoutePlan` (the same
        object the execution path runs); a bare ``(name, M, K, N)`` layer
        list is routed into one first, under ``config`` if given, else under
        the router-decides policy.  ``config`` applies only to that bare-list
        form.  Placement: the plan's routes when collaborative; everything
        on AryPE when not (the 'straightforwardly inserted accelerator')."""
        if not isinstance(plan, RoutePlan):
            cfg = config if config is not None else RuntimeConfig(policy="collaborative")
            plan = RoutePlan.from_layers(plan, config=cfg)
        hw = self.hw
        arype, vpe = [], []
        placements = {}
        for step in plan.steps:
            engine = step.engine if collaborative else "arype"
            placements[step.name] = engine
            cost = self.matmul_cost(step.m, step.k, step.n, engine, collaborative)
            (vpe if engine == "vpe" else arype).append((step.name, cost))
        ary_cycles = sum(c.total_cycles for _, c in arype)
        vpe_cycles = sum(c.total_cycles for _, c in vpe)
        # Engines run concurrently in collaborative mode; serially otherwise.
        total = max(ary_cycles, vpe_cycles) if collaborative else ary_cycles + vpe_cycles
        ary_peak = hw.array_k**2
        vpe_peak = hw.simd_lanes * hw.sublanes * hw.mults_per_sublane
        ary_macs = sum(c.useful_macs for _, c in arype)
        vpe_macs = sum(c.useful_macs for _, c in vpe)
        return {
            "collaborative": collaborative,
            "calibration": None,  # the port has no measured-crossover artifacts
            "placements": placements,
            "arype_eff": ary_macs / (ary_cycles * ary_peak) if ary_cycles else 0.0,
            "vpe_eff": vpe_macs / (vpe_cycles * vpe_peak) if vpe_cycles else 0.0,
            "total_cycles": total,
            "time_s": total / hw.clock_hz,
            "arype_cycles": ary_cycles,
            "vpe_cycles": vpe_cycles,
        }


def usecase2_layers(f: int) -> list[tuple[str, int, int, int]]:
    """Paper use-case 2 CNN matmul shapes for f tracked flows (§4.2)."""
    return [
        ("conv1", 20 * f, 3, 32),
        ("conv2", 10 * f, 96, 32),
        ("conv3", 5 * f, 96, 32),
        ("fc", f, 96, 128),
        ("linear", f, 128, 162),
    ]


def usecase3_layers(f: int) -> list[tuple[str, int, int, int]]:
    """Paper use-case 3 transformer matmul shapes for f tracked flows."""
    out = []
    for name, m, k, n in [
        ("wq", 15, 16, 64),
        ("wk", 15, 16, 64),
        ("wv", 15, 16, 64),
        ("qk", 15, 64, 15),
        ("av", 15, 15, 64),
        ("mlp1", 15, 64, 128),
        ("mlp2", 15, 128, 64),
    ]:
        out.append((name, m * f, k, n))
    return out


def usecase2_plan(f: int, *, config: Optional[RuntimeConfig] = None) -> RoutePlan:
    return RoutePlan.from_layers(usecase2_layers(f), config=config)


def usecase3_plan(f: int, *, config: Optional[RuntimeConfig] = None) -> RoutePlan:
    return RoutePlan.from_layers(usecase3_layers(f), config=config)
