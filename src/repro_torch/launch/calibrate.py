"""Int8 scale calibration for the engine datapath: the port of
``repro/launch/calibrate.py``'s ``calibrate_quant_scales`` and
``quant_divergence_report``.

Scales come from a seeded :class:`TrafficGenerator` sample pushed through an
f32 pipeline, so the flow engine sees tracker-shaped inputs (drained and
ready series rows), and then through both engines under
:func:`repro_torch.runtime.record_scales`.  A greedy pass per decision
stream then drops the layers whose int8 error flips the most decisions.

    from repro_torch.launch.calibrate import calibrate_quant_scales
    table = calibrate_quant_scales(mlp_params, cnn_params, device="cuda")
    cfg = RuntimeConfig(quantize=True, quant_scales=table)

The parameters are arguments (the reference initialises its own from JAX
``PRNGKey``s, which the port cannot replay; ``convert.params_from_numpy``
carries them over).  The flow model is the CNN; the payload transformer is
not ported yet.  The reference's crossover sweep (``tau``/``vpe_max_elems``)
and its CLI are not ported either.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from repro_torch.common.util import Device, resolve_device
from repro_torch.core import decisions
from repro_torch.core.feature_extractor import packet_meta_features
from repro_torch.data.traffic import TrafficConfig, TrafficGenerator
from repro_torch.models import paper_models
from repro_torch.runtime.config import RuntimeConfig
from repro_torch.runtime.quant import QuantScales, record_scales
from repro_torch.serving import OctopusPipeline, PipelineConfig


def traffic_config(table_size: int = 256, seed: int = 7) -> TrafficConfig:
    """The reference's calibration traffic: few concurrent flows sharing each
    microbatch, so flows mature to ready within a short drive (the flow
    engine only ever classifies drained flows)."""
    return TrafficConfig(batch_size=32, active_flows=8, elephant_fraction=0.4,
                         table_size=table_size, seed=seed)


def _check_flow_model(flow_model: str) -> None:
    if flow_model != "cnn":
        raise NotImplementedError(f"flow_model {flow_model!r}: only the cnn flow "
                                  "model is ported")


def _pipeline_config(tcfg: TrafficConfig) -> PipelineConfig:
    return PipelineConfig(batch_size=tcfg.batch_size, max_ready=8, flow_model="cnn",
                          table_size=tcfg.table_size)


def calibrate_quant_scales(pkt_params: dict, flow_params: dict, *, steps: int = 16,
                           traffic: Optional[TrafficConfig] = None,
                           flow_model: str = "cnn",
                           max_flip_rate: Optional[float] = 0.01,
                           device: Device = None) -> QuantScales:
    """Fit per-layer symmetric int8 scales from a seeded traffic sample.

    Drives an f32 pipeline over ``steps`` microbatches and keeps the flow
    rows it drains plus the ready rows still in the table (immature rows
    never reach the engine), then records max-abs statistics of every routed
    matmul while both engines run on the sample: per tensor for activations,
    per output channel for weights.

    With ``max_flip_rate`` set, each decision stream (packet allow/deny, flow
    class) is pruned on its own: while the stream's sample flip rate against
    f32 exceeds the target, the layer whose removal leaves the fewest flips
    goes back to f32 (ties go to the earlier layer).  ``None`` returns the
    full table."""
    _check_flow_model(flow_model)
    dev = resolve_device(device)
    tcfg = traffic if traffic is not None else traffic_config()
    gen = TrafficGenerator(tcfg, device=dev)
    batches = [gen.next_batch() for _ in range(steps)]
    base = RuntimeConfig()
    pipe = OctopusPipeline(pkt_params, flow_params, _pipeline_config(tcfg),
                           config=base, device=dev)
    pkt_params, flow_params = pipe.packet_engine.params, pipe.flow_engine.params
    top_n = pipe.state.series.shape[1]
    rows = []
    for b in batches:
        out = pipe.step(b)
        if out.drained.mask.any():
            x = pipe.flow_engine.prep(out.drained.series, out.drained.payload)
            rows.append(x[out.drained.mask])
        ready = pipe.state.count >= top_n
        if ready.any():
            rows.append(pipe.flow_engine.prep(pipe.state.series, pipe.state.payload)[ready])
    # with no decision rows the sample is one zero row (the scales stay eps-guarded)
    flow_x = torch.cat(rows) if rows else torch.zeros((1, paper_models.CNN_SEQ), device=dev)
    pkt_x = torch.cat([packet_meta_features(b) for b in batches])

    with record_scales() as rec:
        paper_models.mlp_apply(pkt_params, pkt_x, config=base)
        paper_models.cnn_apply(flow_params, flow_x, config=base)
    full = rec.scales()
    if max_flip_rate is None or not full.entries:
        return full

    def stream_layers(fn: Callable, params: dict, x: torch.Tensor) -> tuple[str, ...]:
        with record_scales() as r:
            fn(params, x[:1], config=base)
        return tuple(r.stats)

    def prune_stream(names: Sequence[str], decide: Callable) -> set:
        ref = decide(base)
        target = max_flip_rate * ref.numel()

        def flips(active) -> int:
            qcfg = dataclasses.replace(base, quantize=True, quant_scales=full.subset(active))
            return int((decide(qcfg) != ref).sum())

        dropped: set = set()
        active = [n for n in names if n in full.names()]
        while active and flips(active) > target:
            scored = [(n, flips([m for m in active if m != n])) for n in active]
            drop, _ = min(scored, key=lambda kv: kv[1])
            active.remove(drop)
            dropped.add(drop)
        return dropped

    dropped = prune_stream(
        stream_layers(paper_models.mlp_apply, pkt_params, pkt_x),
        lambda cfg: decisions.decide_binary(
            paper_models.mlp_apply(pkt_params, pkt_x, config=cfg)))
    if rows:  # the zero-row sample has no decisions to measure against
        dropped |= prune_stream(
            stream_layers(paper_models.cnn_apply, flow_params, flow_x),
            lambda cfg: torch.argmax(
                paper_models.cnn_apply(flow_params, flow_x, config=cfg), dim=-1))
    return full.subset(tuple(n for n in full.names() if n not in dropped))


def quant_divergence_report(scales: QuantScales, pkt_params: dict, flow_params: dict, *,
                            steps: int = 10, traffic: Optional[TrafficConfig] = None,
                            flow_model: str = "cnn", device: Device = None
                            ) -> tuple[str, dict]:
    """Int8-vs-f32 differential on the seeded stream: two pipelines (f32, and
    int8 under ``scales``) on identically seeded traffic.  Reports the
    decision flips (packet allow/deny, flow class on drained rows) and
    whether the tracker state stayed bit-exact, as it must: only engine
    outputs quantize.  Returns ``(report_text, metrics)``."""
    _check_flow_model(flow_model)
    dev = resolve_device(device)
    tcfg = traffic if traffic is not None else traffic_config()
    pcfg = _pipeline_config(tcfg)
    ref = OctopusPipeline(pkt_params, flow_params, pcfg, config=RuntimeConfig(), device=dev)
    q = OctopusPipeline(pkt_params, flow_params, pcfg,
                        config=RuntimeConfig(quantize=True, quant_scales=scales), device=dev)
    gen_a, gen_b = TrafficGenerator(tcfg, device=dev), TrafficGenerator(tcfg, device=dev)
    pkt_flips = pkt_total = flow_flips = flow_total = 0
    state_exact = True
    for _ in range(steps):
        oa, ob = ref.step(gen_a.next_batch()), q.step(gen_b.next_batch())
        pkt_flips += int((oa.pkt_actions != ob.pkt_actions).sum())
        pkt_total += oa.pkt_actions.numel()
        mask = oa.drained.mask
        flow_flips += int((oa.flow_cls[mask] != ob.flow_cls[mask]).sum())
        flow_total += int(mask.sum())
        state_exact &= all(torch.equal(a, b) for a, b in zip(ref.state, q.state))
    metrics = {
        "pkt_flips": pkt_flips, "pkt_total": pkt_total,
        "flow_flips": flow_flips, "flow_total": flow_total,
        "pkt_flip_rate": pkt_flips / max(pkt_total, 1),
        "flow_flip_rate": flow_flips / max(flow_total, 1),
        "tracker_bit_exact": state_exact,
    }
    text = (
        f"int8-vs-f32 differential ({flow_model}, {steps} microbatches, "
        f"scales {scales.fingerprint}):\n"
        f"  decision flips: pkt {pkt_flips}/{pkt_total} "
        f"({100 * metrics['pkt_flip_rate']:.2f}%), "
        f"flow {flow_flips}/{flow_total} "
        f"({100 * metrics['flow_flip_rate']:.2f}%)\n"
        f"  tracker state bit-exact: {'yes' if state_exact else 'NO'}")
    return text, metrics
