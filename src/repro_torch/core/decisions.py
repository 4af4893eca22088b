"""Control domain / RV-core analogue (paper §3.4): turn DL inference outputs
into data-plane rule-table updates (paper working-procedure steps 5-6).

A :class:`DecisionHead` maps what the pipeline computed for one microbatch to
data-plane actions: a packet head ``decide(logits, packets) -> (P,) int32``
(:class:`BinaryHead`), a flow head ``decide(logits, drained) -> (actions,
cls, scores)``, all ``(R,)`` (:class:`ClassHead`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Protocol, runtime_checkable

import numpy as np
import torch

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
