"""The paper's working procedure on the PyTorch/CUDA port, path by path:

  packets -> feature extractor (whole trace, segmented merge)
          -> packet path (use-case 1: MLP intrusion verdicts, latency)
          -> flow paths  (use-case 2: 1D-CNN; use-case 3: payload transformer)
          -> decisions   (rule-table updates)

then the three scenarios over the streaming pipeline: heavy hitter
(feature-only heads), DDoS (anomaly scores and a hysteresis deny band) and
a collision attack.  Weights are seeded and random.  Runs on the card
unless ``--device cpu`` is given (the kernels' plain versions).

  PYTHONPATH=src python examples/innetwork_paths_torch.py [--flows 400]
      [--steps 16] [--device cpu]
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import numpy as np
import torch

from repro_torch.core.feature_extractor import FeatureExtractor
from repro_torch.data import PacketTraceConfig, TrafficConfig, TrafficGenerator, synth_packet_trace
from repro_torch.models.paper_models import init_paper_model
from repro_torch.scenarios import (
    AdversarialScenario,
    DDoSScenario,
    HeavyHitterScenario,
    adversarial_config,
)
from repro_torch.serving import (
    FlowPath,
    OctopusPipeline,
    PacketPath,
    PathStats,
    PipelineConfig,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--flows", type=int, default=400)
    ap.add_argument("--steps", type=int, default=16, help="microbatches a scenario")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    dev = args.device
    sync = (lambda: torch.cuda.synchronize()) if torch.device(dev or "cuda").type == "cuda" \
        else (lambda: None)

    packets, *_ = synth_packet_trace(PacketTraceConfig(num_flows=args.flows), device=dev)
    n = int(packets.ts.shape[0])
    ex = FeatureExtractor(device=dev)
    ex.extract_segmented(packets)  # warm: the kernel library and the allocator
    sync()
    t0 = time.perf_counter()
    ex.extract_segmented(packets)
    sync()
    dt = time.perf_counter() - t0
    state, _ = ex.segmented_update(ex.init_state(), packets)
    print(f"[extract] {args.flows} flows, {n} packets: {n / dt / 1e6:.2f} Mpkt/s "
          f"(the paper's FPGA: 31 Mpkt/s)")

    seeded = lambda kind, seed: init_paper_model(kind, torch.Generator().manual_seed(seed),
                                                 device="cpu")
    mlp, cnn, tf = seeded("mlp", 0), seeded("cnn", 1), seeded("transformer", 2)
    ppath = PacketPath(mlp, device=dev)
    for batch in (1, 8):
        ppath.warmup(batch)
        for i in range(32):
            ppath.process(type(packets)(*(a[i * batch:(i + 1) * batch] for a in packets)))
        print(f"[usecase1] batch {batch}: {ppath.stats.latency_us:.1f} us a call "
              f"(host {ppath.stats.host_us:.1f} / device wait {ppath.stats.device_us:.1f}; "
              f"the paper's FPGA: 207 ns a packet)")
        ppath.stats = PathStats()

    live = state.count > 0
    ids = state.tuple_id[live].cpu().numpy()
    for model, params in (("cnn", cnn), ("transformer", tf)):
        fpath = FlowPath(params, model, device=dev)
        x = fpath.engine.prep(state.series[live], state.payload[live])
        fpath.warmup(x.shape[0])
        cls = fpath.process(x, ids)
        paper = {"cnn": 90, "transformer": 35.7}[model]
        print(f"[usecase{2 if model == 'cnn' else 3}] {model}: {x.shape[0]} flows, "
              f"{fpath.stats.throughput / 1e3:.1f} kflow/s, {len(set(cls.tolist()))} classes "
              f"(the paper's FPGA: {paper} kflow/s)")

    shape = dict(batch_size=256, max_ready=32, table_size=1024)
    hh = HeavyHitterScenario(k=5, cold_size=4096, device=dev, **shape)
    hh.run(TrafficGenerator(TrafficConfig(batch_size=256, active_flows=4096, table_size=1024,
                                          collision_free=False, seed=7), device=dev), args.steps)
    print(f"[heavy hitter] spilled {hh.pipe.stats.spilled}, promoted {hh.pipe.stats.promoted}; "
          f"top 5 {hh.top_k()}")
    elephants = lambda: TrafficGenerator(TrafficConfig(
        batch_size=256, active_flows=64, table_size=1024, elephant_fraction=1.0, seed=7),
        device=dev)
    # the deny band from a probe's score quantiles (random weights score low)
    probe = DDoSScenario(deny_on=0.99, deny_off=0.0, device=dev, **shape)
    probe.run(elephants(), args.steps)
    on, off = np.quantile([score for _, score in probe.emissions], [0.6, 0.4])
    ddos = DDoSScenario(deny_on=on, deny_off=off, device=dev, **shape)
    ddos.run(elephants(), args.steps)
    print(f"[ddos] band [{off:.5f}, {on:.5f}]: {len(ddos.emissions)} flows scored, "
          f"{len(ddos.denied)} denied, churn {ddos.churn} (a bare threshold: {ddos.churn_raw})")
    attack = AdversarialScenario(OctopusPipeline(mlp, cnn, PipelineConfig(**shape), device=dev),
                                 adversarial_config("collision_attack", batch_size=256,
                                                    table_size=1024, active_flows=64,
                                                    adv_slots=8))
    s = attack.run(args.steps)
    print(f"[collision attack] {s.step_us:.0f} us a step, {s.evicted} evictions, "
          f"{s.fallback_steps} of {s.steps} steps on the scan fallback")


if __name__ == "__main__":
    main()
