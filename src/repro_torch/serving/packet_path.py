"""The model-invoke cores of the two serving paths (paper §2.3 Table 1):
:class:`PacketEngine` (use-case 1 MLP on per-packet features, the
latency-critical VPE side) and :class:`FlowEngine` (use-case 2 CNN on drained
flows' interval series, the throughput AryPE side)."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.models import paper_models
from repro_torch.runtime.config import RuntimeConfig

FLOW_MODELS = ("cnn",)  # the payload transformer is not ported yet


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


class FlowEngine:
    """Model-invoke core of the flow path (use-case 2 CNN on interval
    series)."""

    def __init__(self, params: dict, model: str = "cnn", *,
                 config: Optional[RuntimeConfig] = None):
        if model not in FLOW_MODELS:
            raise ValueError(f"model must be one of {FLOW_MODELS}, got {model!r}")
        self.params = params
        self.model = model
        self.runtime = config if config is not None else RuntimeConfig()

    def fn(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        return paper_models.cnn_apply(params, x, config=self.runtime)

    def prep(self, series: torch.Tensor, payload: torch.Tensor) -> torch.Tensor:
        """Tracker memories -> model input: the log1p interval series."""
        return torch.log1p(series.float())
