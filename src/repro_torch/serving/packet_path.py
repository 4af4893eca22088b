"""The in-network serving paths (paper §2.3 Table 1):

  * :class:`PacketPath`: packet granularity, latency-critical: inference on
    small batches (1-10 packets, one a PHY port), the VPE side of the
    paper's split; reports latency a call.
  * :class:`FlowPath`: flow granularity, throughput-critical: batched
    inference over the ready flows (up to the 8k flow table), the AryPE
    side; reports flows a second.

Both run inference and decide, and feed the decisions into a rule table
(the paper's steps 4 -> 6).  Their model-invoke cores are
:class:`PacketEngine` (use-case 1 MLP on per-packet features) and
:class:`FlowEngine` (use-case 2 CNN on drained flows' interval series, or
use-case 3 transformer on their payload bytes), which the streaming
:class:`~repro_torch.serving.pipeline.OctopusPipeline` composes too.  Each
engine reports its placement as a :class:`RoutePlan` traced on ``meta``
tensors."""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.common.util import Device, resolve_device
from repro_torch.core import decisions
from repro_torch.core.feature_extractor import packet_meta_features
from repro_torch.core.flow_tracker import PacketBatch
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

    def decide(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """logits -> binary intrusion actions (0 allow / 1 deny)."""
        return decisions.decide_binary(self.fn(params, x))

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


def _on_device(params: dict, device: torch.device) -> dict:
    return {name: value.to(device) for name, value in params.items()}


class PacketPath:
    """Use-case 1: per-packet MLP intrusion detection, a standalone wrapper
    around :class:`PacketEngine` with stats and a rule table, on ``device``
    (the card unless another is named; the parameters move there)."""

    def __init__(self, params: dict, *, config: Optional[RuntimeConfig] = None,
                 device: Device = None):
        self.device = resolve_device(device)
        self.engine = PacketEngine(_on_device(params, self.device), config=config)
        self.rules = decisions.RuleTable()
        self.stats = PathStats()

    @property
    def params(self) -> dict:
        return self.engine.params

    @property
    def runtime(self) -> RuntimeConfig:
        return self.engine.runtime

    def route_plan(self, batch: int = 1) -> RoutePlan:
        return self.engine.route_plan(batch)

    def warmup(self, batch: int = 1) -> None:
        """One call at this batch size (the kernel library's build, the
        allocator), not recorded."""
        x = torch.zeros((batch, self.engine.feature_dim), device=self.device)
        self.engine.decide(self.params, x).cpu()

    def process(self, packets: PacketBatch) -> np.ndarray:
        """Decide every packet: allow 0 / deny 1 as a (P,) int32 array, also
        written to the rule table.  The stats take the enqueue of the model
        and the decision as host time and the wait for the verdicts' copy
        back as device time; an empty submit records nothing."""
        feats = packet_meta_features(PacketBatch(*(a.to(self.device) for a in packets)))
        if feats.shape[0] == 0:  # empty submit: no inference, no stats skew
            return np.zeros((0,), np.int32)
        t0 = time.perf_counter()
        out = self.engine.decide(self.params, feats)  # enqueue only
        t1 = time.perf_counter()
        actions = out.cpu().numpy()  # waits for the device
        t2 = time.perf_counter()
        self.stats.record(t2 - t0, feats.shape[0], host_s=t1 - t0, device_s=t2 - t1)
        self.rules.update(packets.tuple_hash.cpu().numpy(), actions)
        return actions


class FlowPath:
    """Use-cases 2/3: classification of ready flows, a standalone wrapper
    around :class:`FlowEngine` with stats and a rule table, on ``device``
    (the card unless another is named; the parameters move there)."""

    def __init__(self, params: dict, model: str = "cnn", *,
                 config: Optional[RuntimeConfig] = None, device: Device = None):
        self.device = resolve_device(device)
        self.engine = FlowEngine(_on_device(params, self.device), model, config=config)
        self.rules = decisions.RuleTable()
        self.stats = PathStats()

    @property
    def params(self) -> dict:
        return self.engine.params

    @property
    def model(self) -> str:
        return self.engine.model

    @property
    def runtime(self) -> RuntimeConfig:
        return self.engine.runtime

    def route_plan(self, flows: int) -> RoutePlan:
        return self.engine.route_plan(flows)

    def warmup(self, flows: int) -> None:
        """One call at this many flows, not recorded."""
        x = torch.zeros(self.engine.abstract_input(flows).shape, device=self.device)
        self.engine.fn(self.params, x).cpu()

    def process(self, flow_inputs: torch.Tensor, flow_ids: np.ndarray) -> np.ndarray:
        """Classify prepared flow inputs (:meth:`FlowEngine.prep`'s output):
        the (R,) int32 classes, also written to the rule table (action
        ``mark``) under ``flow_ids``.  Host time is the enqueue of the model
        and the argmax, device time the wait for the result's copy back; an
        empty submit records nothing."""
        if flow_inputs.shape[0] == 0:  # empty submit: no inference, no stats skew
            return np.zeros((0,), np.int32)
        x = flow_inputs.to(self.device)
        t0 = time.perf_counter()
        actions, cls = decisions.decide_class(self.engine.fn(self.params, x))  # enqueue only
        out = torch.stack([actions, cls])
        t1 = time.perf_counter()
        actions, cls = out.cpu().numpy()  # waits for the device
        t2 = time.perf_counter()
        self.stats.record(t2 - t0, x.shape[0], host_s=t1 - t0, device_s=t2 - t1)
        self.rules.update(np.asarray(flow_ids), actions, cls)
        return cls
