"""The model-invoke cores of the two serving paths (paper §2.3 Table 1):
:class:`PacketEngine` (use-case 1 MLP on per-packet features, the
latency-critical VPE side) and :class:`FlowEngine` (use-case 2 CNN on drained
flows' interval series, or use-case 3 transformer on their payload bytes: the
throughput AryPE side).  Each reports its placement as a :class:`RoutePlan`
traced on ``meta`` tensors."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.models import paper_models
from repro_torch.runtime.config import RuntimeConfig
from repro_torch.runtime.plan import RoutePlan

FLOW_MODELS = tuple(paper_models.FLOW_APPLY)  # ("cnn", "transformer")

# The transformer's payload scaling.  The reference divides by 255.0 under
# jax.jit, where XLA turns the division by a constant into a multiply by its
# f32 reciprocal; the port multiplies by that reciprocal on every device, so
# its input equals the reference pipeline's bit for bit (a true division
# differs in the last bit on 126 of the 256 byte values).
PAYLOAD_SCALE = float(np.float32(1) / np.float32(255))


@dataclass
class PathStats:
    calls: int = 0
    total_s: float = 0.0
    items: int = 0
    host_s: float = 0.0  # host share: feature staging + dispatch enqueue
    device_s: float = 0.0  # exposed device wait (the synchronize)

    @property
    def latency_us(self) -> float:
        """Mean wall time per call; ``nan`` until something was processed."""
        return self.total_s / self.calls * 1e6 if self.calls else math.nan

    @property
    def host_us(self) -> float:
        return self.host_s / self.calls * 1e6 if self.calls else math.nan

    @property
    def device_us(self) -> float:
        return self.device_s / self.calls * 1e6 if self.calls else math.nan

    @property
    def throughput(self) -> float:
        """Items/sec; 0.0 until something was processed."""
        return self.items / max(self.total_s, 1e-12) if self.items else 0.0

    def record(self, dt_s: float, items: int, *, host_s: float = 0.0,
               device_s: float = 0.0) -> None:
        """Fold one timed call in; empty calls are dropped."""
        if items == 0:
            return
        self.calls += 1
        self.total_s += dt_s
        self.items += items
        self.host_s += host_s
        self.device_s += device_s


class PacketEngine:
    """Model-invoke core of the packet path (use-case 1 MLP)."""

    feature_dim = 6  # packet_meta_features output width

    def __init__(self, params: dict, *, config: Optional[RuntimeConfig] = None):
        self.params = params
        self.runtime = config if config is not None else RuntimeConfig()

    def fn(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        return paper_models.mlp_apply(params, x, config=self.runtime)

    def abstract_input(self, batch: int) -> torch.Tensor:
        return torch.empty((batch, self.feature_dim), device="meta")

    def route_plan(self, batch: int = 1) -> RoutePlan:
        """Placement report for a batch of this size (nothing runs)."""
        return RoutePlan.trace(self.fn, self.params, self.abstract_input(batch),
                               config=self.runtime)


class FlowEngine:
    """Model-invoke core of the flow path (use-case 2 CNN on interval series,
    use-case 3 transformer on payload matrices)."""

    def __init__(self, params: dict, model: str = "cnn", *,
                 config: Optional[RuntimeConfig] = None):
        if model not in FLOW_MODELS:
            raise ValueError(f"model must be one of {FLOW_MODELS}, got {model!r}")
        self.params = params
        self.model = model
        self.runtime = config if config is not None else RuntimeConfig()

    def fn(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        return paper_models.FLOW_APPLY[self.model](params, x, config=self.runtime)

    def prep(self, series: torch.Tensor, payload: torch.Tensor) -> torch.Tensor:
        """Tracker memories -> model input: the log1p interval series for the
        CNN, the payload bytes scaled to [0, 1] for the transformer."""
        if self.model == "cnn":
            return torch.log1p(series.float())
        return payload.float() * PAYLOAD_SCALE

    def abstract_input(self, flows: int) -> torch.Tensor:
        shape = ((flows, paper_models.CNN_SEQ) if self.model == "cnn"
                 else (flows, paper_models.TF_PKTS, paper_models.TF_BYTES))
        return torch.empty(shape, device="meta")

    def route_plan(self, flows: int) -> RoutePlan:
        """Placement report for this many flows (nothing runs)."""
        return RoutePlan.trace(self.fn, self.params, self.abstract_input(flows),
                               config=self.runtime)
