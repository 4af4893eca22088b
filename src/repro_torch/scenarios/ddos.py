"""DDoS / anomaly scoring: the flow engine's scores thresholded into deny
actions that feed the switch-facing rule table, with host-side hysteresis so
flapping flows do not thrash the table.

On the device the pipeline runs an :class:`~repro_torch.core.decisions.
AnomalyHead`: every drained flow gets a float32 score (the malicious class's
softmax probability, ``PipelineStepOutput.flow_scores``), and a score at or
above ``deny_on`` emits a deny at once.  On the host the controller keeps
what the stateless head cannot:

  * hysteresis: a flow enters the denied set at ``score >= deny_on`` and
    leaves it only at ``score <= deny_off`` (``deny_off < deny_on``), so
    scores inside the band cause no rule-table writes; a shadow
    bare-threshold controller on the same emissions counts what it would
    write (``churn <= churn_raw``);
  * re-assertion: the pipeline's packet-granularity feedback overwrites a
    flow's action with the packet head's verdict whenever the flow sends a
    packet, so after each dispatch (a step, or a ``scan_len`` chunk) the
    controller writes ``deny`` again for every denied flow; a denied flow is
    unmarked for at most one dispatch.
"""
from __future__ import annotations

import itertools
from typing import Iterable, Optional

import numpy as np

from repro_torch.common.util import Device
from repro_torch.core import decisions
from repro_torch.runtime.config import RuntimeConfig
from repro_torch.scenarios.heavy_hitter import make_pipeline
from repro_torch.serving import PipelineConfig

_DENY = decisions.ACTIONS.index("deny")


class HysteresisController:
    """Host-side denied set with a hysteresis band, and a shadow
    bare-threshold controller on the same emissions.

    A flow enters ``denied`` at ``score >= deny_on`` and leaves it only at
    ``score <= deny_off`` (strictly ``deny_off < deny_on``); each transition
    is a rule-table write, counted in ``churn``.  The shadow flips on every
    threshold crossing and counts ``churn_raw``; with a strict band
    ``churn <= churn_raw`` always holds."""

    def __init__(self, deny_on: float, deny_off: float):
        if not 0.0 <= deny_off < deny_on <= 1.0:
            raise ValueError(f"need 0 <= deny_off < deny_on <= 1, got "
                             f"deny_off={deny_off} deny_on={deny_on}")
        self.deny_on, self.deny_off = float(deny_on), float(deny_off)
        self.denied: set[int] = set()  # hysteresis state
        self._raw_denied: set[int] = set()  # shadow bare-threshold state
        self.churn = 0  # denied-set transitions (what hits the rule table)
        self.churn_raw = 0  # transitions a bare threshold would make
        self.emissions: list[tuple[int, float]] = []  # (fid, score) history

    def observe(self, fid: int, score: float) -> None:
        self.emissions.append((fid, score))
        raw = score >= self.deny_on  # shadow: flips on every crossing
        if raw != (fid in self._raw_denied):
            self.churn_raw += 1
            (self._raw_denied.add if raw else self._raw_denied.discard)(fid)
        if fid in self.denied:
            if score <= self.deny_off:  # released only below the band
                self.denied.discard(fid)
                self.churn += 1
        elif score >= self.deny_on:
            self.denied.add(fid)
            self.churn += 1


class DDoSScenario:
    """Anomaly-score pipeline and hysteresis deny controller.

    ``**cfg_kwargs`` go to :class:`PipelineConfig`; the flow head is the
    scenario's :class:`~repro_torch.core.decisions.AnomalyHead` at
    ``deny_on``.  ``num_shards > 0`` runs the sharded pipeline."""

    def __init__(self, *, deny_on: float = 0.6, deny_off: float = 0.4,
                 malicious_class: int = 0, num_shards: int = 0,
                 lane_batch: Optional[int] = None, pkt_params: Optional[dict] = None,
                 flow_params: Optional[dict] = None, config: Optional[RuntimeConfig] = None,
                 device: Device = None, **cfg_kwargs):
        if "flow_head" in cfg_kwargs:
            raise ValueError("flow_head is fixed by the scenario "
                             "(AnomalyHead; tune deny_on/malicious_class)")
        self.ctl = HysteresisController(deny_on, deny_off)
        self.cfg = PipelineConfig(flow_head=decisions.AnomalyHead(
            deny_threshold=deny_on, malicious_class=malicious_class), **cfg_kwargs)
        self.pipe = make_pipeline(self.cfg, pkt_params, flow_params, num_shards=num_shards,
                                  lane_batch=lane_batch, config=config, device=device)

    @property
    def denied(self) -> set[int]:
        return self.ctl.denied

    @property
    def churn(self) -> int:
        return self.ctl.churn

    @property
    def churn_raw(self) -> int:
        return self.ctl.churn_raw

    @property
    def emissions(self) -> list[tuple[int, float]]:
        return self.ctl.emissions

    def _absorb(self, out) -> None:
        """Fold one dispatch's emissions (a step, or a stacked chunk) into
        the controller, in step order."""
        mask = out.drained.mask.cpu().numpy()
        fids = out.drained.tuple_id.cpu().numpy()
        scores = out.flow_scores.cpu().numpy()
        if mask.ndim == 1:
            mask, fids, scores = mask[None], fids[None], scores[None]
        for j in range(mask.shape[0]):
            for fid, s in zip(fids[j][mask[j]].tolist(), scores[j][mask[j]].tolist()):
                self.ctl.observe(int(fid), float(s))

    def _reassert(self) -> None:
        """Write deny again for every denied flow (the packet-granularity
        feedback has just overwritten it with the packet head's verdict)."""
        if self.denied:
            fids = np.fromiter(self.denied, np.int64, len(self.denied))
            self.pipe.rules.update(fids, np.full(len(fids), _DENY, np.int32))

    def step(self, batch):
        out = self.pipe.step(batch)
        self._absorb(out)
        self._reassert()
        return out

    def run(self, traffic: Iterable, steps: int):
        """Drive ``steps`` microbatches (in ``scan_len`` chunks, as
        ``OctopusPipeline.run``; a short last chunk step by step), absorbing
        the scores and re-asserting the denies after every dispatch.  Returns
        the pipeline's stats."""
        it = iter(traffic)
        L = self.cfg.scan_len
        done = 0
        while done < steps:
            chunk = list(itertools.islice(it, min(L, steps - done)))
            if not chunk:
                break
            if L > 1 and len(chunk) == L:
                out = self.pipe.step_many(chunk)
                self._absorb(out)
                self._reassert()
            else:
                # the reference compiles its single-step function here
                # before a short chunk; nothing compiles in the port
                for b in chunk:
                    self.step(b)
            done += len(chunk)
        return self.pipe.stats
