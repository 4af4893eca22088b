"""Measure the arype/vpe crossover on a device and persist it, with the
int8 scale calibration of the engine datapath: the port of
``repro/launch/calibrate.py``.

    PYTHONPATH=src python -m repro_torch.launch.calibrate                # the card, cache path
    PYTHONPATH=src python -m repro_torch.launch.calibrate --out calib.json
    PYTHONPATH=src python -m repro_torch.launch.calibrate --smoke        # 8-point grid
    PYTHONPATH=src python -m repro_torch.launch.calibrate --device cpu   # plain versions

:func:`main` sweeps the (m, k, n) timing grid (``repro_torch.runtime.autotune``)
on the card unless ``--device`` names another device, fits the crossover into
``tau``/``vpe_max_elems``, writes the backend-keyed artifact, and reports,
per paper use-case model, every layer whose placement under the calibrated
thresholds differs from the analytic one (:func:`divergence_report`).

With ``--quant`` (on by default) it also fits the int8 datapath's per-layer
scales: from a seeded :class:`TrafficGenerator` sample pushed through an f32
pipeline, so the flow engine sees tracker-shaped inputs (the drained and
ready rows' series or payloads), and then through both engines under
:func:`repro_torch.runtime.record_scales`.  A greedy pass per decision
stream drops the layers whose int8 error flips the most decisions.  The
table covers the packet MLP, the CNN and (unless ``--smoke``) the payload
transformer, one :func:`calibrate_quant_scales` call per flow model merged by
:func:`calibrate_quant_tables`, and persists in the same artifact.

    from repro_torch.launch.calibrate import calibrate_quant_scales
    table = calibrate_quant_scales(mlp_params, cnn_params, device="cuda")
    cfg = RuntimeConfig(quantize=True, quant_scales=table)

The parameters are arguments (the reference initialises its own from JAX
``PRNGKey``s, which the port cannot replay; ``convert.params_from_numpy``
carries them over; :func:`main` draws the port's own from seeds 0 and 1).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Callable, Mapping, Optional, Sequence

import torch

from repro_torch.common.util import Device, resolve_device
from repro_torch.core import decisions
from repro_torch.core.collaborative import usecase2_layers, usecase3_layers
from repro_torch.core.feature_extractor import packet_meta_features
from repro_torch.data.traffic import TrafficConfig, TrafficGenerator
from repro_torch.models import paper_models
from repro_torch.runtime import autotune, platform
from repro_torch.runtime.config import RuntimeConfig
from repro_torch.runtime.plan import RoutePlan
from repro_torch.runtime.quant import QuantScales, record_scales
from repro_torch.serving import OctopusPipeline, PipelineConfig

# Paper-model matmul stacks the report compares (the MLP at a per-packet batch
# of 8; the flow use-cases at 1000 tracked flows, the paper's Table 6 point).
_MLP_LAYERS = [("w0", 8, 6, 12), ("w1", 8, 12, 6), ("w2", 8, 6, 3), ("w3", 8, 3, 2)]


def _model_stacks(flows: int) -> list[tuple[str, list[tuple[str, int, int, int]]]]:
    return [
        ("usecase1_mlp(batch=8)", _MLP_LAYERS),
        (f"usecase2_cnn(flows={flows})", usecase2_layers(flows)),
        (f"usecase3_transformer(flows={flows})", usecase3_layers(flows)),
    ]


def divergence_report(calibrated: RuntimeConfig, *, flows: int = 1000,
                      analytic: Optional[RuntimeConfig] = None, verbose: bool = False) -> str:
    """Per paper-model layer, where the calibrated placement differs from the
    analytic default (and the full calibrated plan when ``verbose``)."""
    analytic = analytic if analytic is not None else RuntimeConfig()
    lines = []
    for label, layers in _model_stacks(flows):
        a_plan = RoutePlan.from_layers(layers, config=analytic)
        c_plan = RoutePlan.from_layers(layers, config=calibrated)
        moved = [(a, c) for a, c in zip(a_plan.steps, c_plan.steps) if a.engine != c.engine]
        lines.append(f"{label}:")
        if not moved:
            lines.append("  placement unchanged by calibration")
        for a, c in moved:
            lines.append(f"  {a.name}  ({a.m},{a.k},{a.n})  "
                         f"{a.engine} -> {c.engine}  (util={c.route.util:.3f})")
        if verbose:
            lines.extend("  " + ln for ln in c_plan.explain().splitlines())
    return "\n".join(lines)


def traffic_config(table_size: int = 256, seed: int = 7) -> TrafficConfig:
    """The reference's calibration traffic: few concurrent flows sharing each
    microbatch, so flows mature to ready within a short drive (the flow
    engine only ever classifies drained flows)."""
    return TrafficConfig(batch_size=32, active_flows=8, elephant_fraction=0.4,
                         table_size=table_size, seed=seed)


def _pipeline_config(tcfg: TrafficConfig, flow_model: str) -> PipelineConfig:
    return PipelineConfig(batch_size=tcfg.batch_size, max_ready=8, flow_model=flow_model,
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
    dev = resolve_device(device)
    tcfg = traffic if traffic is not None else traffic_config()
    gen = TrafficGenerator(tcfg, device=dev)
    batches = [gen.next_batch() for _ in range(steps)]
    base = RuntimeConfig()
    pipe = OctopusPipeline(pkt_params, flow_params, _pipeline_config(tcfg, flow_model),
                           config=base, device=dev)
    flow_apply = paper_models.FLOW_APPLY[flow_model]
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
    flow_x = (torch.cat(rows) if rows
              else torch.zeros(pipe.flow_engine.abstract_input(1).shape, device=dev))
    pkt_x = torch.cat([packet_meta_features(b) for b in batches])

    with record_scales() as rec:
        paper_models.mlp_apply(pkt_params, pkt_x, config=base)
        flow_apply(flow_params, flow_x, config=base)
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
            stream_layers(flow_apply, flow_params, flow_x),
            lambda cfg: torch.argmax(flow_apply(flow_params, flow_x, config=cfg), dim=-1))
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
    dev = resolve_device(device)
    tcfg = traffic if traffic is not None else traffic_config()
    pcfg = _pipeline_config(tcfg, flow_model)
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


def calibrate_quant_tables(pkt_params: dict, flow_params: Mapping[str, dict], *,
                           steps: int = 16, traffic: Optional[TrafficConfig] = None,
                           max_flip_rate: Optional[float] = 0.01,
                           device: Device = None) -> QuantScales:
    """One int8 table over the packet MLP and every flow model of
    ``flow_params`` (``{"cnn": params, "transformer": params}``), as the
    reference's ``calibrate_quant_scales(flow_models=...)`` fits it: one
    :func:`calibrate_quant_scales` call per flow model, the tables merged.

    Each call records and prunes the MLP on the same traffic sample, so
    their MLP entries agree (checked); the flow models' layer names are
    disjoint, and the streams are pruned independently in the reference
    too.  Entries are in name order, as the reference's table keeps them."""
    entries: dict = {}
    for model, params in flow_params.items():
        table = calibrate_quant_scales(pkt_params, params, steps=steps, traffic=traffic,
                                       flow_model=model, max_flip_rate=max_flip_rate,
                                       device=device)
        for name, sx, sw in table.entries:
            if entries.setdefault(name, (name, sx, sw)) != (name, sx, sw):
                raise ValueError(f"layer {name!r} calibrates differently beside {model}")
    return QuantScales(tuple(entries[name] for name in sorted(entries)))


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="calibrate tau/vpe_max_elems from measured crossover points")
    ap.add_argument("--out", default=None,
                    help="artifact path (default: the backend-keyed cache path, "
                         f"{autotune.cache_dir()}/calib-torch-<backend>.json)")
    ap.add_argument("--device", default=None,
                    help="torch device to measure (default: the card; 'cpu' times the "
                         "plain versions)")
    ap.add_argument("--smoke", action="store_true",
                    help="8-point grid, 2 timing iters")
    ap.add_argument("--iters", type=int, default=None,
                    help="timing iterations per shape per path (default 5; 2 with --smoke)")
    ap.add_argument("--flows", type=int, default=1000,
                    help="tracked flows for the paper-model divergence report")
    ap.add_argument("--verbose", action="store_true",
                    help="print the full calibrated RoutePlan per model")
    ap.add_argument("--quant", default=True, action=argparse.BooleanOptionalAction,
                    help="also fit int8 per-layer scales from a traffic sample and report "
                         "decision flips (--no-quant skips)")
    ap.add_argument("--quant-steps", type=int, default=None,
                    help="traffic microbatches for scale fitting (default 16; 6 with --smoke)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    print(f"[calibrate] platform: {platform.fingerprint_id(device=dev)} "
          f"({platform.device_count(dev)} device(s))")
    iters = args.iters if args.iters is not None else (2 if args.smoke else 5)
    grid = autotune.default_grid(smoke=args.smoke)
    print(f"[calibrate] sweeping {len(grid)} (m,k,n) shapes x 2 engine paths "
          f"({iters} iters each)...")
    calib = autotune.calibrate(grid, iters=iters, device=dev)
    if args.quant:
        q_steps = args.quant_steps if args.quant_steps is not None else (
            6 if args.smoke else 16)
        flow_models = ("cnn",) if args.smoke else ("cnn", "transformer")
        print(f"[calibrate] fitting int8 scales from {q_steps} traffic microbatches "
              f"({', '.join(flow_models)})...")
        pkt = paper_models.init_paper_model("mlp", torch.Generator().manual_seed(0), device=dev)
        flows = {m: paper_models.init_paper_model(m, torch.Generator().manual_seed(1),
                                                  device=dev) for m in flow_models}
        scales = calibrate_quant_tables(pkt, flows, steps=q_steps, device=dev)
        calib = dataclasses.replace(calib, quant_scales=scales)
    path = autotune.save_calibration(calib, args.out)

    analytic = RuntimeConfig()
    n_vpe = sum(1 for t in calib.timings if t.vpe_wins)
    print(f"[calibrate] vpe won {n_vpe}/{len(calib.timings)} shapes")
    print(f"[calibrate] analytic: tau={analytic.tau} vpe_max_elems={analytic.vpe_max_elems}")
    print(f"[calibrate] measured: tau={calib.tau:.4f} vpe_max_elems={calib.vpe_max_elems}")
    print(f"[calibrate] artifact: {path}")
    print()
    print("placement divergence (analytic -> calibrated):")
    print(divergence_report(calib.apply(analytic), flows=args.flows, verbose=args.verbose))
    if args.quant and calib.quant_scales is not None:
        print(f"[calibrate] int8 scales: {calib.quant_scales.fingerprint} "
              f"({len(calib.quant_scales.entries)} layers)")
        q_steps = args.quant_steps if args.quant_steps is not None else (
            6 if args.smoke else 10)
        text, _ = quant_divergence_report(calib.quant_scales, pkt, flows["cnn"], steps=q_steps,
                                          device=dev)
        print()
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
