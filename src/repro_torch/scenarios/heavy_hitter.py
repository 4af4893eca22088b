"""Heavy-hitter / top-k detection: rank the resident flows by accumulated
bytes from the tracker state alone, the telemetry use-case the paper serves
without entering the DL domain.

The pipeline runs feature-only heads (:class:`~repro_torch.core.decisions.
PassHead` for packets, :class:`~repro_torch.core.decisions.TopKHead` for
flows), so neither engine launches a kernel; a step is the tracker merge and
the drain.  The top-k set is read on the host from the resident counters:
every live flow in the hot bank (all lanes) and every cold-store resident,
so a heavy hitter that lost its hot slot to a collision keeps its byte count
in the ranking.  Drained (ready) flows leave the tracker, and the ranking.
"""
from __future__ import annotations

from typing import Iterable, Optional

import torch

from repro_torch.common.util import Device
from repro_torch.core import decisions
from repro_torch.kernels.flow_features.ops import HIST
from repro_torch.models import paper_models
from repro_torch.runtime.config import RuntimeConfig
from repro_torch.serving import OctopusPipeline, PipelineConfig, ShardedOctopusPipeline

_FLOW_SIZE = HIST["flow_size"]  # the tracker's byte-counter history lane


def _absorb(counters: dict[int, int], tuple_id: torch.Tensor, count: torch.Tensor,
            features: torch.Tensor) -> None:
    """Fold one table's live rows into ``counters``; lane axes flatten (a
    flow lives in one lane, so no key meets another bank's).  Only the live
    rows' two values cross to the host."""
    live = count.reshape(-1) > 0
    tid = tuple_id.reshape(-1)[live].cpu().tolist()
    size = features.reshape(-1, features.shape[-1])[live, _FLOW_SIZE].cpu().tolist()
    counters.update(zip(tid, size))


def flow_counters(state) -> dict[int, int]:
    """``{tuple_hash: byte count}`` for every flow resident in ``state``, hot
    and cold levels and every lane: a
    :class:`~repro_torch.core.flow_tracker.TrackerState`, a
    :class:`~repro_torch.core.cold_store.TwoLevelState`, or their lane
    stacks.  No tuple is live in hot and cold at once (the scrub), so the
    dict is well defined."""
    counters: dict[int, int] = {}
    if hasattr(state, "hot"):
        for level in (state.hot, state.cold):
            _absorb(counters, level.tuple_id, level.count, level.features)
    else:
        _absorb(counters, state.tuple_id, state.count, state.features)
    return counters


def top_k_flows(counters: dict[int, int], k: int) -> list[tuple[int, int]]:
    """The ``k`` heaviest flows as ``[(tuple_hash, bytes), ...]``, heaviest
    first; ties go to the smaller tuple hash, a total order, so two rankings
    of equal counters are equal lists."""
    return sorted(counters.items(), key=lambda kv: (-kv[1], kv[0]))[:k]


def default_params(flow_model: str) -> tuple[dict, dict]:
    """Seeded random weights (MLP seed 0, the flow model seed 1) on the CPU;
    the pipeline moves them to its device."""
    return (paper_models.init_paper_model("mlp", torch.Generator().manual_seed(0), device="cpu"),
            paper_models.init_paper_model(flow_model, torch.Generator().manual_seed(1),
                                          device="cpu"))


def make_pipeline(cfg: PipelineConfig, pkt_params: Optional[dict], flow_params: Optional[dict],
                  *, num_shards: int, lane_batch: Optional[int],
                  config: Optional[RuntimeConfig], device: Device):
    """The scenario's pipeline: sharded when ``num_shards > 0``, with the
    default weights for any not given."""
    default_pkt, default_flow = (default_params(cfg.flow_model)
                                 if pkt_params is None or flow_params is None else (None, None))
    pkt_params = default_pkt if pkt_params is None else pkt_params
    flow_params = default_flow if flow_params is None else flow_params
    if num_shards:
        return ShardedOctopusPipeline(pkt_params, flow_params, cfg, num_shards=num_shards,
                                      lane_batch=lane_batch, config=config, device=device)
    return OctopusPipeline(pkt_params, flow_params, cfg, config=config, device=device)


class HeavyHitterScenario:
    """Drive a pipeline with feature-only heads and report the top k after
    each step.

    ``**cfg_kwargs`` go to :class:`PipelineConfig`; the heads are the
    scenario's.  The flow head runs no model, so ``top_n`` is free of the
    models' geometry.  ``num_shards > 0`` runs the sharded pipeline (the
    ranking then spans every lane's banks)."""

    def __init__(self, *, k: int = 8, num_shards: int = 0, lane_batch: Optional[int] = None,
                 pkt_params: Optional[dict] = None, flow_params: Optional[dict] = None,
                 config: Optional[RuntimeConfig] = None, device: Device = None, **cfg_kwargs):
        if k <= 0:
            raise ValueError(f"k must be positive, got {k}")
        for reserved in ("pkt_head", "flow_head"):
            if reserved in cfg_kwargs:
                raise ValueError(f"{reserved} is fixed by the scenario")
        self.cfg = PipelineConfig(pkt_head=decisions.PassHead(),
                                  flow_head=decisions.TopKHead(), **cfg_kwargs)
        self.k = k
        self.pipe = make_pipeline(self.cfg, pkt_params, flow_params, num_shards=num_shards,
                                  lane_batch=lane_batch, config=config, device=device)

    def step(self, batch):
        return self.pipe.step(batch)

    def counters(self) -> dict[int, int]:
        """The resident flows' byte counters (hot and cold, every lane)."""
        return flow_counters(self.pipe.state)

    def top_k(self) -> list[tuple[int, int]]:
        """The current top k ``(tuple_hash, bytes)``, heaviest first."""
        return top_k_flows(self.counters(), self.k)

    def run(self, traffic: Iterable, steps: int) -> list[list[tuple[int, int]]]:
        """Drive ``steps`` microbatches; returns the top k after each (the
        pipeline's stats accumulate on ``self.pipe.stats``)."""
        it = iter(traffic)
        snaps = []
        for _ in range(steps):
            self.pipe.step(next(it))
            snaps.append(self.top_k())
        return snaps
