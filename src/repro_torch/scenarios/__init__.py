"""Use-case scenarios over the streaming pipelines (the paper: the
accelerator serves many in-network DL workloads, not one).  Each composes
the trackers, engines and rule table through the pluggable
:class:`~repro_torch.core.decisions.DecisionHead` layer:

  * :class:`HeavyHitterScenario`: top-k flows by byte counter, feature-only
    heads (no inference at all);
  * :class:`DDoSScenario`: the flow engine's anomaly scores thresholded into
    deny actions, with host-side hysteresis feeding the rule table;
  * :class:`AdversarialScenario`: flash-crowd, elephant-storm and
    hash-collision traffic (``TrafficConfig.adversarial``) through a
    pipeline.
"""
from repro_torch.scenarios.adversarial import AdversarialScenario, adversarial_config
from repro_torch.scenarios.ddos import DDoSScenario, HysteresisController
from repro_torch.scenarios.heavy_hitter import (
    HeavyHitterScenario,
    flow_counters,
    top_k_flows,
)

SCENARIOS = ("heavy_hitter", "ddos", "adversarial")

__all__ = ["AdversarialScenario", "DDoSScenario", "HeavyHitterScenario",
           "HysteresisController", "SCENARIOS", "adversarial_config",
           "flow_counters", "top_k_flows"]
