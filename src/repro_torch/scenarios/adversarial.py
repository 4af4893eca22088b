"""Adversarial traffic: drive a pipeline with the ``TrafficConfig.adversarial``
modes and measure what the attack costs.  The generator
(:mod:`repro_torch.data.traffic`) owns the attack shapes:

  * ``flash_crowd``: every ``adv_period``-th batch is all fresh one-packet
    flows (maximal establishment churn);
  * ``elephant_storm``: every flow an elephant, every emission a maximal
    burst (the ready/drain path under line-rate pressure);
  * ``collision_attack``: the whole population hashes into ``adv_slots``
    tracker slots (worst-case eviction churn, and the segmented tracker's
    in-batch collision fallback every batch), optionally pinned to lane 0 of
    ``adv_shards`` lanes.

The attack costs throughput, never correctness: the tracker stays exact.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Union

from repro_torch.data.traffic import ADVERSARIAL_MODES, TrafficConfig, TrafficGenerator

ATTACKS = tuple(m for m in ADVERSARIAL_MODES if m != "none")


def adversarial_config(mode: str, **overrides) -> TrafficConfig:
    """A :class:`TrafficConfig` with defaults that stress the mode's target
    path (any field overridable): ``collision_attack`` with
    ``collision_free=False`` and more flows than its slots;
    ``flash_crowd``/``elephant_storm`` on small tables, so the churn shows at
    test sizes."""
    if mode not in ATTACKS:
        raise ValueError(f"mode must be one of {ATTACKS}, got {mode!r}")
    base = {
        "flash_crowd": TrafficConfig(adversarial="flash_crowd", active_flows=24,
                                     table_size=256, collision_free=False),
        "elephant_storm": TrafficConfig(adversarial="elephant_storm", active_flows=16,
                                        table_size=256, burst_len=8),
        "collision_attack": TrafficConfig(adversarial="collision_attack", active_flows=12,
                                          table_size=64, adv_slots=2, collision_free=False),
    }[mode]
    return replace(base, **overrides)


class AdversarialScenario:
    """One pipeline and one adversarial generator; ``run`` reports the
    sustained stats.  A config makes a generator on the pipeline's device."""

    def __init__(self, pipe, traffic: Union[TrafficConfig, TrafficGenerator]):
        cfg = traffic.cfg if isinstance(traffic, TrafficGenerator) else traffic
        if cfg.adversarial == "none":
            raise ValueError("AdversarialScenario needs an adversarial "
                             "TrafficConfig (adversarial != 'none')")
        self.pipe = pipe
        self.gen = (traffic if isinstance(traffic, TrafficGenerator)
                    else TrafficGenerator(traffic, device=pipe.device))

    @property
    def mode(self) -> str:
        return self.gen.cfg.adversarial

    def run(self, steps: int):
        """Drive ``steps`` microbatches through the pipeline; returns its
        :class:`~repro_torch.serving.pipeline.PipelineStats` (the new-flow and
        eviction counters show the attack's churn)."""
        return self.pipe.run(self.gen, steps=steps)
