#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # from the root of a checkout, on a machine with one card
    python3 chip_smoke.py --profile  # also trace 8 pipeline steps for the device-busy share

Phases, each of which fails the run (non-zero exit) when it fails:

  1. the card's name and power limit, and the build of the kernel library
     from ``src/repro_torch/csrc`` (nvcc, sm_90a);
  2. every kernel of the pipeline's path against its plain PyTorch version on
     the card, at the shapes the pipeline gives it (``flow_update`` exact,
     the matmuls within rtol 1e-5, atol 1e-5 * max|ref|), with times of the
     kernel, the plain version and one PyTorch library call;
  3. the streaming pipeline at the paper's 8k flow table (batch 1024, 256
     drained flows per step, CNN flow model, seeded random weights) for 64
     steps, with every kernel launch counted;
  4. the same traffic and weights through the pipeline on the card and on the
     CPU (plain versions): tracker state and drained rows bit-identical at
     every step, decisions identical away from near-tied logits; once on
     ordinary traffic and once on a collision attack that drives the scan
     fallback.

The second-to-last line is the JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``.  TF32 is off everywhere: the reference
computes in full f32.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MATMUL_RTOL = 1e-5  # only the order of the f32 sums differs from the plain version
NEAR_TIE = 1e-4  # logit gap under which the two devices may decide differently
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # H100 SXM data sheet, f32 outside the tensor cores

PIPE = dict(table_size=8192, batch_size=1024, max_ready=256)
TRAFFIC = dict(batch_size=1024, active_flows=4096, table_size=8192, seed=0)
ATTACK = dict(batch_size=1024, active_flows=256, table_size=8192, seed=1,
              adversarial="collision_attack", collision_free=False, adv_slots=64)
# (name, m, k, n) of every engine matmul of one pipeline step at PIPE
VPE_SHAPES = [("pkt/w0", 1024, 6, 12), ("pkt/w1", 1024, 12, 6), ("pkt/w2", 1024, 6, 3),
              ("pkt/w3", 1024, 3, 2), ("flow/conv1", 5120, 3, 32)]
ARYPE_SHAPES = [("flow/conv2", 2560, 96, 32), ("flow/conv3", 1280, 96, 32),
                ("flow/fc", 256, 96, 128), ("flow/linear", 256, 128, 162)]


def log(*args) -> None:
    print(*args, flush=True)


def time_ms(fn, *, calls: int = 20, reps: int = 5) -> float:
    """Device time per call: ``calls`` back-to-back calls between two CUDA
    events, queued behind a sleep kernel so the host's enqueue cost stays
    hidden (a call that synchronises inside shows its host time too).
    Median of ``reps``."""
    import torch

    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / calls)
    return statistics.median(samples)


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    """Least time (ms) for the work: bytes over the memory rate or operations
    over the f32 rate, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_matmuls(torch, engine, plain, shapes, gen) -> dict:
    """Kernel vs plain on the card at each shape (all four activations at the
    first), and per-step times summed over the shapes."""
    err, ms, plain_ms, lib_ms, bound_ms, ops, nbytes = 0.0, 0.0, 0.0, 0.0, 0.0, 0, 0
    for i, (name, m, k, n) in enumerate(shapes):
        x = torch.randn(m, k, generator=gen).cuda()
        w = torch.randn(k, n, generator=gen).cuda()
        for act in (("none", "relu", "silu", "gelu") if i == 0 else ("none",)):
            out, ref = engine(x, w, activation=act), plain(x, w, activation=act)
            torch.cuda.synchronize()
            tol = MATMUL_RTOL * ref.abs().max().item()
            if not torch.allclose(out, ref, rtol=MATMUL_RTOL, atol=tol):
                raise AssertionError(f"{engine.__name__} {name} {act}: max err "
                                     f"{(out - ref).abs().max().item()} over tol {tol}")
            err = max(err, (out - ref).abs().max().item())
        t = time_ms(lambda: engine(x, w))
        tp = time_ms(lambda: plain(x, w))
        tl = time_ms(lambda: torch.matmul(x, w))
        b, _ = bound(4 * (m * k + k * n + m * n), 2 * m * k * n)
        log(f"  {engine.__name__} {name} ({m},{k},{n}): kernel {t:.5f} ms, plain {tp:.5f} ms, "
            f"torch.matmul {tl:.5f} ms, bound {b:.6f} ms")
        ms, plain_ms, lib_ms, bound_ms = ms + t, plain_ms + tp, lib_ms + tl, bound_ms + b
        ops += 2 * m * k * n
        nbytes += 4 * (m * k + k * n + m * n)
    _, by = bound(nbytes, ops)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=by, library_ms=lib_ms,
                bytes=nbytes, flops=ops)


def check_flow_update(torch, ff, gen) -> dict:
    """flow_update vs its plain fold, bit for bit: the default program on
    pipeline-shaped input, a random program whose hist_src crosses lanes with
    every op and wrapping values, and long colliding segments."""
    F, P = PIPE["table_size"], PIPE["batch_size"]
    rand32 = lambda *shape: torch.randint(-2**31, 2**31, shape, generator=gen,
                                          dtype=torch.int64).to(torch.int32)
    cross = torch.stack([torch.arange(16) % 7, torch.randint(0, 13, (16,), generator=gen),
                         (torch.arange(16) * 5 + 3) % 16], dim=1).to(torch.int32)
    cases = [
        ("default", ff.default_program("cpu"), torch.randint(0, F + 1, (P,), generator=gen)),
        ("cross-lane", cross, torch.randint(0, F + 1, (P,), generator=gen)),
        ("colliding", cross, torch.randint(0, 4, (P,), generator=gen)),
    ]
    for name, program, slots in cases:
        args = [program, slots.to(torch.int32), rand32(P, 13), rand32(F, 16)]
        ref = ff.flow_feature_update_plain(*(a.cuda() for a in args))
        out = ff.flow_feature_update(*(a.cuda() for a in args))
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"flow_update {name}: {(out != ref).sum().item()} lanes differ")
        log(f"  flow_update {name}: bit-exact over {P} packets")
    args = [a.cuda() for a in (ff.default_program("cpu"), cases[0][2].to(torch.int32),
                               rand32(P, 13), rand32(F, 16))]
    t = time_ms(lambda: ff.flow_feature_update(*args))
    tp = time_ms(lambda: ff.flow_feature_update_plain(*args), calls=5)
    nbytes = 4 * (16 * 3 + P + 13 * P + 16 * F) + 4 * 16 * F
    b, by = bound(nbytes, 16 * P)  # 32-bit ALU ops at the f32 rate
    log(f"  flow_update (P={P}, F={F}): wrapper {t:.5f} ms, plain {tp:.5f} ms, "
        f"bound {b:.6f} ms ({nbytes} bytes)")
    return dict(max_abs_err=0, ms=t, plain_ms=tp, bound_ms=b, bound_by=by,
                library_ms=None, bytes=nbytes, flops=16 * P)


def make_batches(TrafficConfig, TrafficGenerator, cfg: dict, steps: int, device):
    gen = TrafficGenerator(TrafficConfig(**cfg), device=device)
    return [gen.next_batch() for _ in range(steps)]


def compare_runs(torch, ft, fx, pipes, batches, label: str) -> tuple[int, int]:
    """Drive the card and CPU pipelines over the same batches.  Returns the
    count of near-tied decisions (CPU logit gap under NEAR_TIE) and how many
    of them came out differently; any other difference fails."""
    gpu, cpu = pipes
    near = flipped = 0
    for step, batch in enumerate(batches):
        out_g = gpu.step(ft.PacketBatch(*(a.cuda() for a in batch)))
        out_c = cpu.step(batch)
        for name, a, b in zip(ft.TrackerState._fields, gpu.state, cpu.state):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"{label} step {step}: TrackerState.{name} differs")
        for name, a, b in zip(ft.DrainResult._fields, out_g.drained, out_c.drained):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"{label} step {step}: DrainResult.{name} differs")
        pkt_logits = cpu.packet_engine.fn(cpu.packet_engine.params,
                                          fx.packet_meta_features(batch))
        pkt_tie = (pkt_logits[:, 1] - pkt_logits[:, 0]).abs() < NEAR_TIE
        pkt_diff = out_g.pkt_actions.cpu() != out_c.pkt_actions
        flow_logits = cpu.flow_engine.fn(cpu.flow_engine.params,
                                         cpu.flow_engine.prep(out_c.drained.series, None))
        top2 = flow_logits.topk(2, dim=-1).values
        flow_tie = ((top2[:, 0] - top2[:, 1]) < NEAR_TIE) & out_c.drained.mask
        flow_diff = (out_g.flow_cls.cpu() != out_c.flow_cls) & out_c.drained.mask
        if (pkt_diff & ~pkt_tie).any() or (flow_diff & ~flow_tie).any():
            raise AssertionError(f"{label} step {step}: {int((pkt_diff & ~pkt_tie).sum())} "
                                 f"packet verdicts and {int((flow_diff & ~flow_tie).sum())} "
                                 "flow classes differ away from a near tie")
        near += int(pkt_tie.sum()) + int(flow_tie.sum())
        flipped += int(pkt_diff.sum()) + int(flow_diff.sum())
    if not flipped and gpu.rules.rules != cpu.rules.rules:
        raise AssertionError(f"{label}: rule tables differ with identical decisions")
    return near, flipped


def profile_steps(torch, pipe, batches, step_us: float) -> None:
    """Device-busy time per step from a torch.profiler trace of a few steps,
    against the unprofiled step time: the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pipe.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for batch in batches:
            pipe.step(batch)
    # device-side events only: a CPU op's self device time repeats its kernels'
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events) / len(batches)
    if busy_us == 0:
        log("[profile] the trace holds no device time: idle share not measured")
        return
    log(f"[profile] {len(batches)} steps: device busy {busy_us:.1f} us/step of "
        f"{step_us:.1f} us unprofiled, idle share {1 - busy_us / step_us:.4f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  {e.self_device_time_total / len(batches):9.1f} us/step  "
            f"{e.count // len(batches):4d}/step  {e.key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout (src/repro_torch missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch import kernels
    from repro_torch.core import feature_extractor as fx
    from repro_torch.core import flow_tracker as ft
    from repro_torch.data.traffic import TrafficConfig, TrafficGenerator
    from repro_torch.kernels import build
    from repro_torch.kernels.arype_matmul.ops import arype_matmul, mm_fused
    from repro_torch.kernels.flow_features import ops as ff
    from repro_torch.kernels.vpe_smallmm.ops import vpe_matmul, vpe_mm
    from repro_torch.models.paper_models import init_paper_model
    from repro_torch.runtime import record_routes
    from repro_torch.serving import OctopusPipeline, PipelineConfig

    # -- 1. device and build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build.load_library()
    log(f"[build] kernel library ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.build_seconds if build.build_seconds is not None else 'cached'} s)")

    # -- 2. kernels vs plain versions
    gen = torch.Generator().manual_seed(0)
    log("[kernels] each kernel against its plain version on the card")
    results = {
        "flow_update": check_flow_update(torch, ff, gen),
        "vpe_mm": check_matmuls(torch, vpe_matmul, vpe_mm, VPE_SHAPES, gen),
        "mm_fused": check_matmuls(torch, arype_matmul, mm_fused, ARYPE_SHAPES, gen),
    }

    # -- 3. the pipeline on the card
    log("[pipeline] 8k table, batch 1024, 256 drained flows/step, CNN, 64 steps")
    mlp = init_paper_model("mlp", torch.Generator().manual_seed(1), device="cpu")
    cnn = init_paper_model("cnn", torch.Generator().manual_seed(2), device="cpu")
    batches = make_batches(TrafficConfig, TrafficGenerator, TRAFFIC, 64, "cuda")
    pipe = OctopusPipeline(mlp, cnn, PipelineConfig(**PIPE))
    pipe.warmup()
    with record_routes() as routes:
        pipe.step(batches[0])
    placement = [(r.name, r.m, r.k, r.n, r.route.path) for r in routes]
    log("  placement: " + ", ".join(f"{n}({m},{k},{nn})->{p}" for n, m, k, nn, p in placement))
    expected = [(f"pkt/w{i}", "vpe") for i in range(4)] + [("flow/conv1", "vpe")] + [
        (f"flow/{n}", "arype") for n in ("conv2", "conv3", "fc", "linear")]
    if [(n, p) for n, _, _, _, p in placement] != expected:
        raise AssertionError(f"placement {placement} is not the reference's {expected}")
    pipe.reset()
    kernels.reset_launches()
    stats = pipe.run(batches, steps=64)
    counts = kernels.launches()
    log(f"  {stats.pkt_per_s:.1f} pkt/s, {stats.flow_per_s:.1f} flow/s, step {stats.step_us:.1f} us "
        f"(p50 {stats.p50_us:.1f}, p99 {stats.p99_us:.1f}), host {stats.host_us:.1f} us, "
        f"device {stats.device_us:.1f} us")
    log(f"  new flows {stats.new_flows}, evicted {stats.evicted}, flows drained {stats.flows}, "
        f"steps with collision fallback {stats.fallback_steps}")
    log(f"  launches in 64 steps: {counts}")
    if counts != {"flow_update": 64, "vpe_mm": 5 * 64, "mm_fused": 4 * 64}:
        raise AssertionError(f"launch counts {counts}: expected 1, 5 and 4 per step")
    if stats.flows == 0 or stats.steps != 64:
        raise AssertionError("the pipeline drained no flows")
    if "--profile" in sys.argv[1:]:
        profile_steps(torch, pipe, batches[:8], stats.step_us)

    # -- 4. card vs CPU
    for label, cfg, steps in (("ordinary", TRAFFIC, 16), ("collision attack", ATTACK, 8)):
        log(f"[card vs cpu] {label} traffic, {steps} steps")
        batches = make_batches(TrafficConfig, TrafficGenerator, cfg, steps, "cpu")
        pipes = (OctopusPipeline(mlp, cnn, PipelineConfig(**PIPE)),
                 OctopusPipeline(mlp, cnn, PipelineConfig(**PIPE), device="cpu"))
        near, flipped = compare_runs(torch, ft, fx, pipes, batches, label)
        fb = pipes[0].stats.fallback_steps
        log(f"  tracker state and drained rows bit-identical over {steps} steps; decisions "
            f"identical except {flipped} of {near} near ties; collision-fallback steps {fb}")
        if label == "collision attack" and fb != steps:
            raise AssertionError(f"the attack took the fallback on {fb} of {steps} steps")

    # -- 5. records
    source = {"flow_update": "src/repro_torch/csrc/flow_update.cu",
              "vpe_mm": "src/repro_torch/csrc/vpe_mm.cu",
              "mm_fused": "src/repro_torch/csrc/mm_fused.cu"}
    replaces = {"flow_update": "src/repro/kernels/flow_features/flow_features.py:78",
                "vpe_mm": "src/repro/kernels/vpe_smallmm/vpe_smallmm.py:73",
                "mm_fused": "src/repro/kernels/arype_matmul/arype_matmul.py:103"}
    record = [dict(name=name, route="cuda", source=source[name], replaces=replaces[name],
                   launches=counts[name], **r) for name, r in results.items()]
    log(card)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
