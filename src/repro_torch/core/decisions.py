"""Control domain / RV-core analogue (paper §3.4): turn DL inference outputs
into data-plane rule-table updates (paper working-procedure steps 5-6).

A :class:`DecisionHead` maps what the pipeline computed for one microbatch to
data-plane actions, and declares ``needs_logits``: a head without it is
feature-only, and the pipeline then runs no model for it (launches no engine
kernel), as in the heavy-hitter telemetry use-case.

  * packet heads ``decide(logits, packets) -> (P,) int32``: :class:`BinaryHead`
    (use-case 1's intrusion verdict) and :class:`PassHead` (feature-only,
    allow all);
  * flow heads ``decide(logits, drained) -> (actions, cls, scores)``, all
    ``(R,)``: :class:`ClassHead` (use-cases 2/3), :class:`AnomalyHead`
    (DDoS-style deny on the malicious class's probability) and
    :class:`TopKHead` (feature-only byte counters).  ``scores`` is the
    head's float32 score a flow, ``PipelineStepOutput.flow_scores``, which
    the host-side scenarios read (:mod:`repro_torch.scenarios`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.kernels.flow_features.ops import HIST

ACTIONS = ("allow", "deny", "mark")


@dataclass
class RuleTable:
    """The switch-facing rule table the control domain maintains."""

    rules: dict[int, dict] = field(default_factory=dict)
    generation: int = 0

    def update(self, flow_ids: np.ndarray, actions: np.ndarray,
               classes: Optional[np.ndarray] = None):
        self.generation += 1
        for i, fid in enumerate(np.asarray(flow_ids).tolist()):
            fid = int(fid)
            if classes is not None:
                cls = int(classes[i])
            else:  # packet-granularity update: keep the last known flow class
                prev = self.rules.get(fid)
                cls = prev["class"] if prev is not None else -1
            self.rules[fid] = {
                "action": ACTIONS[int(actions[i])],
                "class": cls,
                "generation": self.generation,
            }

    def lookup(self, flow_id: int) -> dict:
        return self.rules.get(int(flow_id), {"action": "allow", "class": -1, "generation": 0})


def decide_binary(logits: torch.Tensor, deny_threshold: float = 0.5) -> torch.Tensor:
    """Binary intrusion decision (use-case 1): logits (..., 2) -> 0 allow /
    1 deny, deny only when the attack probability strictly exceeds the
    threshold."""
    p = torch.softmax(logits.float(), dim=-1)
    return (p[..., 1] > deny_threshold).to(torch.int32)


def decide_class(logits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Classification decision (use-cases 2/3): -> (action=mark, class id);
    ties go to the lowest class, as ``jnp.argmax`` breaks them."""
    cls = torch.argmax(logits, dim=-1).to(torch.int32)
    return torch.full_like(cls, ACTIONS.index("mark")), cls


@runtime_checkable
class DecisionHead(Protocol):
    """What every head declares: a stable ``name`` and whether the pipeline
    must run the matching engine to feed it (``needs_logits``)."""

    name: str
    needs_logits: bool


@dataclass(frozen=True)
class BinaryHead:
    """Packet head, use-case 1: deny when the attack-class softmax
    probability strictly exceeds ``deny_threshold``."""

    deny_threshold: float = 0.5
    name: str = field(default="binary", init=False)
    needs_logits: bool = field(default=True, init=False)

    def decide(self, logits: torch.Tensor, packets) -> torch.Tensor:
        return decide_binary(logits, self.deny_threshold)


@dataclass(frozen=True)
class PassHead:
    """Feature-only packet head: allow every packet; the packet engine never
    runs."""

    name: str = field(default="pass", init=False)
    needs_logits: bool = field(default=False, init=False)

    def decide(self, logits, packets) -> torch.Tensor:
        return torch.zeros(packets.ts.shape, dtype=torch.int32, device=packets.ts.device)


@dataclass(frozen=True)
class ClassHead:
    """Flow head, use-cases 2/3: argmax classification (action ``mark``),
    score = the winning class's softmax confidence."""

    name: str = field(default="class", init=False)
    needs_logits: bool = field(default=True, init=False)

    def decide(self, logits: torch.Tensor, drained
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        actions, cls = decide_class(logits)
        p = torch.softmax(logits.float(), dim=-1)
        return actions, cls, p.max(dim=-1).values


@dataclass(frozen=True)
class AnomalyHead:
    """Flow head, DDoS/anomaly scoring: score = the malicious class's softmax
    probability; ``score >= deny_threshold`` denies the flow (the boundary
    itself denies), anything else marks it with its argmax class."""

    deny_threshold: float = 0.5
    malicious_class: int = 0
    name: str = field(default="anomaly", init=False)
    needs_logits: bool = field(default=True, init=False)

    def decide(self, logits: torch.Tensor, drained
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        score = torch.softmax(logits.float(), dim=-1)[..., self.malicious_class]
        cls = torch.argmax(logits, dim=-1).to(torch.int32)
        actions = torch.where(score >= self.deny_threshold, ACTIONS.index("deny"),
                              ACTIONS.index("mark")).to(torch.int32)
        return actions, cls, score


@dataclass(frozen=True)
class TopKHead:
    """Feature-only flow head, heavy-hitter telemetry: the flow engine never
    runs; every drained flow is scored by its byte counter (the tracker's
    ``flow_size`` history lane), action ``mark``, class -1."""

    name: str = field(default="topk", init=False)
    needs_logits: bool = field(default=False, init=False)

    def decide(self, logits, drained) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        score = drained.features[..., HIST["flow_size"]].float()
        cls = torch.full_like(drained.tuple_id, -1, dtype=torch.int32)
        actions = torch.full_like(cls, ACTIONS.index("mark"))
        return actions, cls, score


PKT_HEADS = {"binary": BinaryHead, "pass": PassHead}
FLOW_HEADS = {"class": ClassHead, "anomaly": AnomalyHead, "topk": TopKHead}


def packet_head(name: str, **params) -> DecisionHead:
    """Registry constructor for packet heads (``PKT_HEADS``)."""
    if name not in PKT_HEADS:
        raise ValueError(f"packet head must be one of {tuple(PKT_HEADS)}, got {name!r}")
    return PKT_HEADS[name](**params)


def flow_head(name: str, **params) -> DecisionHead:
    """Registry constructor for flow heads (``FLOW_HEADS``)."""
    if name not in FLOW_HEADS:
        raise ValueError(f"flow head must be one of {tuple(FLOW_HEADS)}, got {name!r}")
    return FLOW_HEADS[name](**params)
