#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # from the root of a checkout, on a machine with one card
    python3 chip_smoke.py --profile  # also trace 8 steps of the f32/int8 CNN and transformer
                                     # pipelines for the device-busy share

Phases, each of which fails the run (non-zero exit) when it fails:

  1. the card's name and power limit, and the build of the kernel library
     from ``src/repro_torch/csrc`` (nvcc, sm_90a);
  2. every kernel of the pipeline's paths against its plain PyTorch version
     on the card, at the shapes the pipeline gives it (``flow_update`` exact,
     the f32 matmuls within rtol 1e-5, atol 1e-5 * max|ref|, the int8
     matmuls ``vpe_mm_q``/``mm_fused_q`` bit for bit under none/relu with
     per-tensor and per-channel weight scales), with times of the kernel,
     the plain version and one PyTorch library call; ``mm_fused``/``mm_fused_q``
     also at the transformer flow engine's shapes; ``mm_unfused_partials``
     (partials pass and sum pass) also at use-case 2's ``arype_only`` shapes
     for 1000 flows, with the paper's 32-deep K blocks and the reference
     wrapper's 128-deep ones.  Each pipeline phase checks that its step's
     matmuls are the shapes checked here;
  3. the f32 streaming pipeline at the paper's 8k flow table (batch 1024,
     256 drained flows per step, CNN flow model, seeded random weights) for
     64 steps, with every kernel launch counted;
  4. the same traffic and weights through the f32 pipeline on the card and on
     the CPU (plain versions): tracker state and drained rows bit-identical
     at every step, decisions identical away from near-tied logits; once on
     ordinary traffic and once on a collision attack that drives the scan
     fallback;
  5. the int8 engine datapath: the port's calibration (full table, every
     engine layer int8) on the reference's calibration traffic, then the
     pipeline at the same 8k table for 64 steps, launching only the int8
     engine kernels;
  6. the int8 pipeline on the card and on the CPU under the same table for
     64 steps: tracker state, drained rows and packet logits bit-identical;
     flow logits bit-identical on every drained row (and, at the end, every
     live table row) when both engines get the CPU's log1p input, and on
     those rows whose own log1p input is identical; decisions identical away
     from near ties; and the pruned table's layers and its int8-vs-f32 decision
     flips (logged, not asserted);
  7. the paper's "wo/ collaborating" ablation (``fused_aggregation=False``):
     the CNN pipeline for 64 steps, its AryPE convs launching
     ``mm_unfused_partials`` and its sum pass; then the Table 6 variants of
     ``cnn_apply`` at 1000 flows (``arype_only`` fused and unfused,
     ``collaborative`` fused), timed on the card; ``collaborative_forward``
     on the card against the CPU, fused and unfused under both policies,
     with exact launch counts; and the ratio of the FPGA cycle model (the
     paper's hardware, not this card);
  8. the use-case 3 payload transformer as the flow model: the f32 pipeline,
     then the int8 one under a port-calibrated full table, 64 steps each at
     the same geometry, launch counts equal to what ``record_routes`` predicts;
  9. card vs CPU for the transformer (f32 and int8) and the unfused CNN, 64
     steps each (flows first drain after ~30): tracker state and drained
     rows bit-identical, flow logits within the stated tolerance, decisions
     identical except near ties, which are counted;
 10. the placement reports (``OctopusPipeline.explain``) of the CNN and the
     transformer pipelines.

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
# Transformer flow logits, card against CPU, as a share of max|logit|.  f32:
# torch's exp (softmax) and the attention products' summation order differ
# between the devices in the last bits, and six layers carry that forward.
# int8: the attention output is re-quantized before mlp1 (and mlp2, cls), so
# such a last-bit difference can move an input code by one where it sits at a
# half; one code moves a logit by about one quantum of the later layers.
TF_LOGIT_TOL = {"f32": 1e-4, "int8": 2e-2}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # H100 SXM data sheet, f32 outside the tensor cores
INT8_OPS_PER_S = 1979e12  # H100 SXM data sheet, dense int8 tensor-core rate
ACTS = ("none", "relu", "silu", "gelu")

PIPE = dict(table_size=8192, batch_size=1024, max_ready=256)
TRAFFIC = dict(batch_size=1024, active_flows=4096, table_size=8192, seed=0)
ATTACK = dict(batch_size=1024, active_flows=256, table_size=8192, seed=1,
              adversarial="collision_attack", collision_free=False, adv_slots=64)
# (name, m, k, n) of every engine matmul of one pipeline step at PIPE
VPE_SHAPES = [("pkt/w0", 1024, 6, 12), ("pkt/w1", 1024, 12, 6), ("pkt/w2", 1024, 6, 3),
              ("pkt/w3", 1024, 3, 2), ("flow/conv1", 5120, 3, 32)]
ARYPE_SHAPES = [("flow/conv2", 2560, 96, 32), ("flow/conv3", 1280, 96, 32),
                ("flow/fc", 256, 96, 128), ("flow/linear", 256, 128, 162)]
# the transformer flow engine's matmuls at PIPE (256 drained rows of 15 packets)
TF_ARYPE_SHAPES = [("flow/wq", 3840, 16, 64), ("flow/wk", 3840, 16, 64),
                   ("flow/wv", 3840, 16, 64), ("flow/mlp1", 3840, 64, 128),
                   ("flow/mlp2", 3840, 128, 64), ("flow/cls", 256, 64, 162)]
# the pipeline's unfused matmuls under fused_aggregation=False: cnn_apply runs
# its AryPE-placed convs unfused and fc/linear fused, as the reference does
UNFUSED_SHAPES = ARYPE_SHAPES[:2]
TABLE6_FLOWS = 1000
# a stack for collaborative_forward whose last layer the collaborative policy
# places on the VPE; K=300 leaves a ragged last 32-deep block
COLLAB_STACK = [(TABLE6_FLOWS, 300), (300, 64), (64, 96), (96, 8)]
COLLAB_ACTS = ["relu", "gelu", None]
CNN_PLACEMENT = dict([(f"pkt/w{i}", "vpe") for i in range(4)] + [("flow/conv1", "vpe")]
                     + [(f"flow/{n}", "arype") for n in ("conv2", "conv3", "fc", "linear")])
# at 256 drained rows a step every transformer layer's working set is past the
# VPE's cap (the reference's plan): all six run on the AryPE
TF_PLACEMENT = dict([(f"pkt/w{i}", "vpe") for i in range(4)]
                    + [(f"flow/{n}", "arype") for n in ("wq", "wk", "wv", "mlp1", "mlp2", "cls")])


def log(*args) -> None:
    print(*args, flush=True)


def time_ms(fn, *, calls: int = 20, reps: int = 5, sleep_cycles: int = 20_000_000) -> float:
    """Device time per call: ``calls`` back-to-back calls between two CUDA
    events, queued behind a sleep kernel of ``sleep_cycles`` so the host's
    enqueue cost stays hidden (a call that synchronises inside shows its
    host time too, and so do calls whose enqueue outlasts the sleep).
    Median of ``reps``."""
    import torch

    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / calls)
    return statistics.median(samples)


def bound(nbytes: int, ops: int, ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    """Least time (ms) for the work: bytes over the memory rate or operations
    over the peak rate of their type (f32 by default), whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_matmuls(torch, engine, plain, shapes, gen) -> dict:
    """Kernel vs plain on the card at each shape (all four activations at the
    first), and per-step times summed over the shapes."""
    err, ms, plain_ms, lib_ms, bound_ms, ops, nbytes = 0.0, 0.0, 0.0, 0.0, 0.0, 0, 0
    for i, (name, m, k, n) in enumerate(shapes):
        x = torch.randn(m, k, generator=gen).cuda()
        w = torch.randn(k, n, generator=gen).cuda()
        for act in (ACTS if i == 0 else ("none",)):
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


def check_quant_matmuls(torch, engine, plain, shapes, gen) -> dict:
    """Int8 kernel vs its plain twin on the card at each shape, with a
    per-tensor and a per-channel weight scale (all four activations at the
    first shape): bit for bit under none/relu, rtol 1e-5 under silu/gelu.
    Times use per-channel scales.  The library yardstick is
    ``torch._int_mm`` on operands quantized beforehand, where cuBLASLt takes
    the shape (M > 16, K and N multiples of 8); the per-step library time is
    null unless every shape has one."""
    from repro_torch.runtime.quant import pick_scale, quantize_i8

    err, ms, plain_ms, lib_ms, bound_ms, ops, nbytes = 0.0, 0.0, 0.0, 0.0, 0.0, 0, 0
    lib_all = True
    for i, (name, m, k, n) in enumerate(shapes):
        x = (torch.randn(m, k, generator=gen) * 3).cuda()
        w = torch.randn(k, n, generator=gen).cuda()
        sx = pick_scale(x.abs().max().item())
        scales = {"tensor": pick_scale(w.abs().max().item()),
                  "channel": tuple(pick_scale(v) for v in w.abs().amax(0).tolist())}
        for kind, sw in scales.items():
            for act in (ACTS if i == 0 else ("none",)):
                out = engine(x, w, scale_x=sx, scale_w=sw, activation=act)
                ref = plain(x, w, scale_x=sx, scale_w=sw, activation=act)
                torch.cuda.synchronize()
                if act in ("none", "relu"):
                    ok = torch.equal(out, ref)
                else:  # exp/tanh differ between the kernel and torch
                    ok = torch.allclose(out, ref, rtol=MATMUL_RTOL,
                                        atol=MATMUL_RTOL * ref.abs().max().item())
                if not ok:
                    raise AssertionError(f"{engine.__name__} {name} {kind} {act}: max err "
                                         f"{(out - ref).abs().max().item()}")
                err = max(err, (out - ref).abs().max().item())
        sw = scales["channel"]
        t = time_ms(lambda: engine(x, w, scale_x=sx, scale_w=sw))
        tp = time_ms(lambda: plain(x, w, scale_x=sx, scale_w=sw))
        tl = None
        if m > 16 and k % 8 == 0 and n % 8 == 0:
            xq, wq = quantize_i8(x, sx), quantize_i8(w, sw)
            tl = time_ms(lambda: torch._int_mm(xq, wq))
        lib_all = lib_all and tl is not None
        work_bytes, work_ops = 4 * (m * k + k * n + m * n), 2 * m * k * n
        b, _ = bound(work_bytes, work_ops, INT8_OPS_PER_S)
        lib = f"{tl:.5f} ms" if tl is not None else "none (shape not taken by cuBLASLt)"
        log(f"  {engine.__name__} {name} ({m},{k},{n}): kernel {t:.5f} ms, plain {tp:.5f} ms, "
            f"torch._int_mm {lib}, bound {b:.6f} ms")
        ms, plain_ms, bound_ms = ms + t, plain_ms + tp, bound_ms + b
        lib_ms += tl or 0.0
        ops, nbytes = ops + work_ops, nbytes + work_bytes
    _, by = bound(nbytes, ops, INT8_OPS_PER_S)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                library_ms=lib_ms if lib_all else None, bytes=nbytes, flops=ops)


def check_unfused(torch, arype, shapes, gen, bk: int | None) -> dict:
    """``mm_unfused_partials`` and its sum pass against their plain versions
    on the card at each shape (all four activations at the first): the
    partials and the unfused product within MATMUL_RTOL.  Times are of the
    whole unfused matmul (both launches), its plain version and
    ``torch.matmul`` on the same (M, K, N), summed over the shapes.  The
    bound counts x and w read, the partials written and read back, and the
    output written, over the memory rate.  ``bk=None`` is the wrapper's
    default block."""
    depth = bk or arype.BLOCK_K
    err, ms, plain_ms, lib_ms, bound_ms, ops, nbytes = 0.0, 0.0, 0.0, 0.0, 0.0, 0, 0
    for i, (name, m, k, n) in enumerate(shapes):
        x = torch.randn(m, k, generator=gen).cuda()
        w = torch.randn(k, n, generator=gen).cuda()
        nk = -(-k // depth)
        got, ref = (arype.mm_unfused_partials(x, w, bk=depth),
                    arype.mm_unfused_partials_plain(x, w, bk=depth))
        pairs = [("partials", got, ref)]
        for act in (ACTS if i == 0 else ("none",)):
            pairs.append((act, arype.arype_matmul_unfused(x, w, activation=act, bk=bk),
                          arype.mm_unfused(x, w, activation=act, bk=depth)))
        torch.cuda.synchronize()
        if got.shape != (nk, m, n):
            raise AssertionError(f"mm_unfused_partials {name}: shape {tuple(got.shape)}")
        for what, out, want in pairs:
            tol = MATMUL_RTOL * want.abs().max().item()
            if not torch.allclose(out, want, rtol=MATMUL_RTOL, atol=tol):
                raise AssertionError(f"mm_unfused_partials {name} bk={bk} {what}: max err "
                                     f"{(out - want).abs().max().item()} over tol {tol}")
            err = max(err, (out - want).abs().max().item())
        t = time_ms(lambda: arype.arype_matmul_unfused(x, w, bk=bk))
        tp = time_ms(lambda: arype.mm_unfused(x, w, bk=depth))
        tl = time_ms(lambda: torch.matmul(x, w))
        work_bytes = 4 * (m * k + k * n + 2 * nk * m * n + m * n)
        work_ops = 2 * m * k * n + (nk - 1) * m * n
        b, _ = bound(work_bytes, work_ops)
        log(f"  mm_unfused_partials {name} ({m},{k},{n}) bk={depth} "
            f"({nk} partials): kernel {t:.5f} ms, plain {tp:.5f} ms, torch.matmul {tl:.5f} ms, "
            f"bound {b:.6f} ms ({work_bytes} bytes)")
        ms, plain_ms, lib_ms, bound_ms = ms + t, plain_ms + tp, lib_ms + tl, bound_ms + b
        ops, nbytes = ops + work_ops, nbytes + work_bytes
    _, by = bound(nbytes, ops)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                library_ms=lib_ms, bytes=nbytes, flops=ops)


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


def compare_runs(torch, ft, fx, pipes, batches, label: str, *, exact_logits: bool = False,
                 logit_tol: float | None = None) -> dict:
    """Drive the card and CPU pipelines over the same batches; tracker state
    and drained rows must be bit-identical at every step.  Returns counts:
    ``near`` tied decisions (CPU logit gap under the tie threshold),
    ``flipped`` decisions that came out differently, ``prep_differs`` drained
    rows whose flow-model input differs between the devices, and, with
    ``logit_tol``, ``rows_differ`` drained rows whose flow logits are not
    bit-identical and ``max_err`` their largest difference (``max_rel`` as a
    share of the step's max|logit|).

    With ``exact_logits`` (the int8 CNN) the packet logits must be
    bit-identical; so must the flow logits of every drained row when both
    devices' engines are given the CPU's flow-model input, and, with each
    device's own input, on every drained row whose input is identical.  With
    ``logit_tol`` (the transformer) the card's flow logits must lie within
    ``logit_tol * max|logit|`` of the CPU's, and a flow decision counts as
    near a tie when the CPU's top two logits are that close.  Any other
    difference fails."""
    gpu, cpu = pipes
    res = dict(near=0, flipped=0, prep_differs=0, rows_differ=0, max_err=0.0, max_rel=0.0)
    for step, batch in enumerate(batches):
        batch_g = ft.PacketBatch(*(a.cuda() for a in batch))
        out_g = gpu.step(batch_g)
        out_c = cpu.step(batch)
        for name, a, b in zip(ft.TrackerState._fields, gpu.state, cpu.state):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"{label} step {step}: TrackerState.{name} differs")
        for name, a, b in zip(ft.DrainResult._fields, out_g.drained, out_c.drained):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"{label} step {step}: DrainResult.{name} differs")
        mask = out_c.drained.mask
        pkt_logits = cpu.packet_engine.fn(cpu.packet_engine.params,
                                          fx.packet_meta_features(batch))
        pkt_tie = (pkt_logits[:, 1] - pkt_logits[:, 0]).abs() < NEAR_TIE
        pkt_diff = out_g.pkt_actions.cpu() != out_c.pkt_actions
        flow_x = cpu.flow_engine.prep(out_c.drained.series, out_c.drained.payload)
        flow_logits = cpu.flow_engine.fn(cpu.flow_engine.params, flow_x)
        flow_x_g = gpu.flow_engine.prep(out_g.drained.series, out_g.drained.payload)
        flow_tie_gap = NEAR_TIE
        if exact_logits:
            pkt_logits_g = gpu.packet_engine.fn(gpu.packet_engine.params,
                                                fx.packet_meta_features(batch_g))
            if not torch.equal(pkt_logits_g.cpu(), pkt_logits):
                raise AssertionError(f"{label} step {step}: int8 packet logits differ")
            flow_logits_g = gpu.flow_engine.fn(gpu.flow_engine.params, flow_x_g).cpu()
            same = (flow_x_g.cpu() == flow_x).all(dim=1) & mask
            res["prep_differs"] += int((mask & ~same).sum())
            if not torch.equal(flow_logits_g[same], flow_logits[same]):
                raise AssertionError(f"{label} step {step}: int8 flow logits differ on rows "
                                     "whose input is bit-identical")
            shared = gpu.flow_engine.fn(gpu.flow_engine.params, flow_x.cuda()).cpu()
            if not torch.equal(shared, flow_logits):
                raise AssertionError(f"{label} step {step}: int8 flow logits differ on the "
                                     "CPU's flow-model input")
        if logit_tol is not None and mask.any():
            if not torch.equal(flow_x_g.cpu()[mask], flow_x[mask]):
                raise AssertionError(f"{label} step {step}: flow-model inputs differ")
            flow_logits_g = gpu.flow_engine.fn(gpu.flow_engine.params, flow_x_g).cpu()
            flow_tie_gap = logit_tol * flow_logits[mask].abs().max().item()
            diff = (flow_logits_g[mask] - flow_logits[mask]).abs()
            if diff.max().item() > flow_tie_gap:
                raise AssertionError(f"{label} step {step}: flow logits differ by "
                                     f"{diff.max().item()}, over {flow_tie_gap}")
            res["rows_differ"] += int((diff.amax(dim=1) > 0).sum())
            res["max_err"] = max(res["max_err"], diff.max().item())
            res["max_rel"] = max(res["max_rel"],
                                 diff.max().item() / flow_logits[mask].abs().max().item())
        top2 = flow_logits.topk(2, dim=-1).values
        flow_tie = ((top2[:, 0] - top2[:, 1]) < flow_tie_gap) & mask
        flow_diff = (out_g.flow_cls.cpu() != out_c.flow_cls) & mask
        if (pkt_diff & ~pkt_tie).any() or (flow_diff & ~flow_tie).any():
            raise AssertionError(f"{label} step {step}: {int((pkt_diff & ~pkt_tie).sum())} "
                                 f"packet verdicts and {int((flow_diff & ~flow_tie).sum())} "
                                 "flow classes differ away from a near tie")
        res["near"] += int(pkt_tie.sum()) + int(flow_tie.sum())
        res["flipped"] += int(pkt_diff.sum()) + int(flow_diff.sum())
    if not res["flipped"] and gpu.rules.rules != cpu.rules.rules:
        raise AssertionError(f"{label}: rule tables differ with identical decisions")
    return res


def drive_pipeline(kernels, record_routes, pipe, batches, layers: list, expected: dict, *,
                   quantized: bool):
    """Warm up, check one step's matmuls: the ``layers`` (name, m, k, n) whose
    kernels phase 2 checked, the reference's ``expected`` engines, the same
    as the pipeline's meta-traced ``plan()``, every layer int8 when
    ``quantized``, and under ``fused_aggregation=False`` the AryPE convs
    (``UNFUSED_SHAPES``) unfused.  Then run the batches with the launch counts
    set to 0 just before and read just after; they must equal what the
    recorded routes launch (``kernels.matmul_launches``) plus one
    ``flow_update`` a step.  Returns ``(counts, stats)``."""
    pipe.warmup()
    with record_routes() as routes:
        pipe.step(batches[0])
    placement = [(r.name, r.m, r.k, r.n, r.route.path, r.quantized) for r in routes]
    log("  placement: " + ", ".join(
        f"{r.name}({r.m},{r.k},{r.n})->{r.route.path}{'/int8' if r.quantized else ''}"
        f"{'/unfused' if r.unfused else ''}" for r in routes))
    if [(r.name, r.m, r.k, r.n) for r in routes] != layers:
        raise AssertionError(f"the step's matmuls {placement} are not the checked {layers}")
    if {n: p for n, _, _, _, p, _ in placement} != expected or len(placement) != len(expected):
        raise AssertionError(f"placement {placement} is not the reference's {expected}")
    unfused = [(r.name, r.m, r.k, r.n) for r in routes if r.unfused]
    if unfused != ([] if pipe.runtime.fused_aggregation else UNFUSED_SHAPES):
        raise AssertionError(f"unfused matmuls {unfused}")
    planned = [(s.name, s.m, s.k, s.n, s.engine, s.quantized) for s in pipe.plan().steps]
    if planned != placement:
        raise AssertionError(f"the traced plan {planned} is not the step's {placement}")
    if any(q != quantized for *_, q in placement):
        raise AssertionError(f"placement {placement}: every layer should be "
                             f"{'int8' if quantized else 'f32'}")
    pipe.reset()
    kernels.reset_launches()
    stats = pipe.run(batches, steps=len(batches))
    counts = kernels.launches()
    log(f"  {stats.pkt_per_s:.1f} pkt/s, {stats.flow_per_s:.1f} flow/s, step {stats.step_us:.1f} us "
        f"(p50 {stats.p50_us:.1f}, p99 {stats.p99_us:.1f}), host {stats.host_us:.1f} us, "
        f"device {stats.device_us:.1f} us")
    log(f"  new flows {stats.new_flows}, evicted {stats.evicted}, flows drained {stats.flows}, "
        f"steps with collision fallback {stats.fallback_steps}")
    log(f"  launches in {len(batches)} steps: {counts}")
    want = kernels.matmul_launches(routes, len(batches))
    want["flow_update"] += len(batches)
    if counts != want:
        raise AssertionError(f"launch counts {counts}: expected {want}")
    if stats.flows == 0 or stats.steps != len(batches):
        raise AssertionError("the pipeline drained no flows")
    return counts, stats


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
    from repro_torch.core.collaborative import (
        UNFUSED_BK,
        OctopusCycleModel,
        collaborative_forward,
        plan_stack,
        usecase2_layers,
        usecase2_plan,
    )
    from repro_torch.data.traffic import TrafficConfig, TrafficGenerator
    from repro_torch.kernels import build
    from repro_torch.kernels.arype_matmul import ops as arype
    from repro_torch.kernels.flow_features import ops as ff
    from repro_torch.kernels.vpe_smallmm.ops import vpe_matmul, vpe_matmul_q, vpe_mm, vpe_mm_q
    from repro_torch.launch.calibrate import calibrate_quant_scales, quant_divergence_report
    from repro_torch.models.paper_models import cnn_apply, init_paper_model
    from repro_torch.runtime import RuntimeConfig, record_routes
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
    profile = "--profile" in sys.argv[1:]

    # -- 2. kernels vs plain versions
    gen = torch.Generator().manual_seed(0)
    log("[kernels] each kernel against its plain version on the card")
    results = {
        "flow_update": check_flow_update(torch, ff, gen),
        "vpe_mm": check_matmuls(torch, vpe_matmul, vpe_mm, VPE_SHAPES, gen),
        "mm_fused": check_matmuls(torch, arype.arype_matmul, arype.mm_fused, ARYPE_SHAPES, gen),
        "vpe_mm_q": check_quant_matmuls(torch, vpe_matmul_q, vpe_mm_q, VPE_SHAPES, gen),
        "mm_fused_q": check_quant_matmuls(torch, arype.arype_matmul_q, arype.mm_fused_q,
                                          ARYPE_SHAPES, gen),
        "mm_unfused_partials": check_unfused(torch, arype, UNFUSED_SHAPES, gen, UNFUSED_BK),
    }
    log("[kernels] mm_fused and mm_fused_q at the transformer flow engine's shapes")
    for name, engine, plain, check in (
            ("mm_fused", arype.arype_matmul, arype.mm_fused, check_matmuls),
            ("mm_fused_q", arype.arype_matmul_q, arype.mm_fused_q, check_quant_matmuls)):
        r = check(torch, engine, plain, TF_ARYPE_SHAPES, gen)
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], r["max_abs_err"])
        log(f"  {name} per transformer step (6 layers): kernel {r['ms']:.5f} ms, plain "
            f"{r['plain_ms']:.5f} ms, library {r['library_ms']} ms, bound {r['bound_ms']:.6f} ms")
    table6_shapes = usecase2_layers(TABLE6_FLOWS)
    for bk in (UNFUSED_BK, None):
        log(f"[kernels] mm_unfused_partials at use-case 2's arype_only shapes, "
            f"{TABLE6_FLOWS} flows, bk={bk or arype.BLOCK_K}")
        r = check_unfused(torch, arype, table6_shapes, gen, bk)
        log(f"  sum over the 5 layers: kernel {r['ms']:.5f} ms, plain {r['plain_ms']:.5f} ms, "
            f"torch.matmul {r['library_ms']:.5f} ms, bound {r['bound_ms']:.6f} ms")

    # -- 3. the f32 pipeline on the card
    log("[pipeline] f32, 8k table, batch 1024, 256 drained flows/step, CNN, 64 steps")
    mlp = init_paper_model("mlp", torch.Generator().manual_seed(1), device="cpu")
    cnn = init_paper_model("cnn", torch.Generator().manual_seed(2), device="cpu")
    tf = init_paper_model("transformer", torch.Generator().manual_seed(3), device="cpu")
    batches = make_batches(TrafficConfig, TrafficGenerator, TRAFFIC, 64, "cuda")
    pipe = OctopusPipeline(mlp, cnn, PipelineConfig(**PIPE))
    cnn_layers = [shape[:4] for shape in VPE_SHAPES + ARYPE_SHAPES]
    tf_layers = [shape[:4] for shape in VPE_SHAPES[:4] + TF_ARYPE_SHAPES]
    counts, stats = drive_pipeline(kernels, record_routes, pipe, batches, cnn_layers,
                                   CNN_PLACEMENT, quantized=False)
    if profile:
        profile_steps(torch, pipe, batches[:8], stats.step_us)

    # -- 4. card vs CPU, f32
    for label, cfg, steps in (("ordinary", TRAFFIC, 16), ("collision attack", ATTACK, 8)):
        log(f"[card vs cpu] f32, {label} traffic, {steps} steps")
        cpu_batches = make_batches(TrafficConfig, TrafficGenerator, cfg, steps, "cpu")
        pipes = (OctopusPipeline(mlp, cnn, PipelineConfig(**PIPE)),
                 OctopusPipeline(mlp, cnn, PipelineConfig(**PIPE), device="cpu"))
        res = compare_runs(torch, ft, fx, pipes, cpu_batches, label)
        fb = pipes[0].stats.fallback_steps
        log(f"  tracker state and drained rows bit-identical over {steps} steps; decisions "
            f"identical except {res['flipped']} of {res['near']} near ties; "
            f"collision-fallback steps {fb}")
        if label == "collision attack" and fb != steps:
            raise AssertionError(f"the attack took the fallback on {fb} of {steps} steps")

    # -- 5. the int8 pipeline on the card
    t0 = time.perf_counter()
    table = calibrate_quant_scales(mlp, cnn, max_flip_rate=None)
    log(f"[int8] full table {table.fingerprint} ({len(table.entries)} layers: "
        f"{', '.join(table.names())}) calibrated on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    int8 = RuntimeConfig(quantize=True, quant_scales=table)
    log("[pipeline] int8, 8k table, batch 1024, 256 drained flows/step, CNN, 64 steps")
    pipe = OctopusPipeline(mlp, cnn, PipelineConfig(**PIPE), config=int8)
    q_counts, q_stats = drive_pipeline(kernels, record_routes, pipe, batches, cnn_layers,
                                       CNN_PLACEMENT, quantized=True)
    if profile:
        profile_steps(torch, pipe, batches[:8], q_stats.step_us)
    counts.update({name: q_counts[name] for name in ("vpe_mm_q", "mm_fused_q")})

    # -- 6. card vs CPU, int8; 64 steps, since flows first drain after ~30
    steps = 64
    log(f"[card vs cpu] int8, ordinary traffic, {steps} steps")
    cpu_batches = make_batches(TrafficConfig, TrafficGenerator, TRAFFIC, steps, "cpu")
    pipes = (OctopusPipeline(mlp, cnn, PipelineConfig(**PIPE), config=int8),
             OctopusPipeline(mlp, cnn, PipelineConfig(**PIPE), config=int8, device="cpu"))
    res = compare_runs(torch, ft, fx, pipes, cpu_batches, "int8", exact_logits=True)
    drained = pipes[1].stats.flows
    log(f"  tracker state, drained rows and packet logits bit-identical over {steps} steps; "
        f"flow logits bit-identical on all {drained} drained rows given the CPU's log1p "
        f"input, and on the {drained - res['prep_differs']} whose own log1p input is "
        f"identical ({res['prep_differs']} rows differ there: torch's log1p on the card and "
        f"on the CPU); decisions identical except {res['flipped']} of {res['near']} near ties")
    # every live table row through the flow engine on both devices, so the
    # int8 flow path is held at scale even when few flows drained
    gpu, cpu = pipes
    live = cpu.state.count > 0
    x_c = cpu.flow_engine.prep(cpu.state.series[live], None)
    x_g = gpu.flow_engine.prep(gpu.state.series[live.cuda()], None)
    same = (x_g.cpu() == x_c).all(dim=1)
    logits_g = gpu.flow_engine.fn(gpu.flow_engine.params, x_g).cpu()
    logits_c = cpu.flow_engine.fn(cpu.flow_engine.params, x_c)
    if not torch.equal(logits_g[same], logits_c[same]):
        raise AssertionError("int8 flow logits differ on live rows whose input is bit-identical")
    shared = gpu.flow_engine.fn(gpu.flow_engine.params, x_c.cuda()).cpu()
    if not torch.equal(shared, logits_c):
        raise AssertionError("int8 flow logits differ on live rows given the CPU's input")
    log(f"  int8 flow logits on the {int(live.sum())} live table rows: bit-identical on all "
        f"of them given the CPU's log1p input, and on the {int(same.sum())} whose own log1p "
        f"input is identical")
    t0 = time.perf_counter()
    pruned = calibrate_quant_scales(mlp, cnn)
    log(f"[int8] pruned table {pruned.fingerprint} (max_flip_rate 0.01, "
        f"{time.perf_counter() - t0:.2f} s): {', '.join(pruned.names())}")
    for name, scales in (("full", table), ("pruned", pruned)):
        text, _ = quant_divergence_report(scales, mlp, cnn)
        log(f"  [{name}] " + text.replace("\n", "\n  "))

    # -- 7. the "wo/ collaborating" ablation: the unfused CNN loop and Table 6
    unfused = RuntimeConfig(fused_aggregation=False)
    log("[pipeline] f32, fused_aggregation=False, 8k table, batch 1024, 256 drained "
        "flows/step, CNN, 64 steps")
    pipe = OctopusPipeline(mlp, cnn, PipelineConfig(**PIPE), config=unfused)
    u_counts, u_stats = drive_pipeline(kernels, record_routes, pipe, batches, cnn_layers,
                                       CNN_PLACEMENT, quantized=False)
    counts["mm_unfused_partials"] = u_counts["mm_unfused_partials"]
    log(f"[table 6] cnn_apply at {TABLE6_FLOWS} flows on the card (CUDA events, device ms "
        "a forward)")
    cnn_g = {k: v.cuda() for k, v in cnn.items()}
    x = torch.rand(TABLE6_FLOWS, 20, generator=gen).cuda()
    variants = {"arype_only fused": RuntimeConfig(policy="arype_only"),
                "arype_only unfused": RuntimeConfig(policy="arype_only", fused_aggregation=False),
                "collaborative fused": RuntimeConfig(policy="collaborative")}
    t6 = {}
    for name, cfg in variants.items():
        out = cnn_apply(cnn_g, x, config=cfg)
        if not torch.isfinite(out).all() or out.shape != (TABLE6_FLOWS, 162):
            raise AssertionError(f"table 6 {name}: output {tuple(out.shape)} not finite")
        # ten forwards of some 40 small ops each can take longer to enqueue
        # than the default sleep lasts, which would time the host instead
        t6[name] = time_ms(lambda cfg=cfg: cnn_apply(cnn_g, x, config=cfg), calls=10,
                           sleep_cycles=400_000_000)
        log(f"  {name}: {t6[name]:.5f} ms a forward, {TABLE6_FLOWS / t6[name] * 1e3:.1f} flow/s")
    ref = cnn_apply(cnn_g, x, config=variants["arype_only fused"])
    got = cnn_apply(cnn_g, x, config=variants["arype_only unfused"])
    if not torch.allclose(got, ref, rtol=MATMUL_RTOL, atol=MATMUL_RTOL * ref.abs().max().item()):
        raise AssertionError("table 6: unfused logits differ from fused")
    log(f"[collaborative] collaborative_forward on the card against the CPU, stack "
        f"{COLLAB_STACK}")
    xs, *ws = (torch.randn(*shape, generator=gen) for shape in COLLAB_STACK)
    for policy in ("arype_only", "collaborative"):
        for fused in (True, False):
            cfg = RuntimeConfig(policy=policy, fused_aggregation=fused)
            with record_routes() as routes:
                plan = plan_stack(xs, ws, config=cfg)
            want = collaborative_forward(xs, ws, COLLAB_ACTS, plan=plan)
            kernels.reset_launches()
            got = collaborative_forward(xs.cuda(), [w.cuda() for w in ws], COLLAB_ACTS, plan=plan)
            c_counts = kernels.launches()
            got = got.cpu()
            tol = MATMUL_RTOL * want.abs().max().item()
            if not torch.allclose(got, want, rtol=MATMUL_RTOL, atol=tol):
                raise AssertionError(f"collaborative_forward {policy} fused={fused}: max err "
                                     f"{(got - want).abs().max().item()} over tol {tol}")
            if c_counts != kernels.matmul_launches(routes):
                raise AssertionError(f"collaborative_forward {policy} fused={fused}: launches "
                                     f"{c_counts}, expected {kernels.matmul_launches(routes)}")
            launched = {name: n for name, n in c_counts.items() if n}
            err = (got - want).abs().max().item()
            log(f"  {policy} fused={fused}: engines {[s.engine for s in plan.steps]}, max err "
                f"{err:.3e} ({err / want.abs().max().item():.3e} of max|out|), "
                f"launches {launched}")
    model = OctopusCycleModel()
    plan = usecase2_plan(TABLE6_FLOWS)
    off, on = (model.stack_report(plan, collaborative=c) for c in (False, True))
    log(f"  card: unfused/fused {t6['arype_only unfused'] / t6['arype_only fused']:.4f}x, "
        f"arype_only/collaborative {t6['arype_only fused'] / t6['collaborative fused']:.4f}x")
    log(f"  FPGA cycle model (the paper's hardware, not this card): wo/ over w/ collaborating "
        f"{off['time_s'] / on['time_s']:.4f}x ({TABLE6_FLOWS / off['time_s'] / 1e3:.1f} -> "
        f"{TABLE6_FLOWS / on['time_s'] / 1e3:.1f} kflow/s, AryPE efficiency "
        f"{off['arype_eff']:.3f} -> {on['arype_eff']:.3f}; paper 53 -> 90 kflow/s, 1.69x)")

    # -- 8. the payload transformer on the loop
    tf_pipe = dict(PIPE, flow_model="transformer")
    log("[pipeline] f32, 8k table, batch 1024, 256 drained flows/step, transformer, 64 steps")
    pipe = OctopusPipeline(mlp, tf, PipelineConfig(**tf_pipe))
    _, tf_stats = drive_pipeline(kernels, record_routes, pipe, batches, tf_layers,
                                 TF_PLACEMENT, quantized=False)
    if profile:
        profile_steps(torch, pipe, batches[:8], tf_stats.step_us)
    t0 = time.perf_counter()
    tf_table = calibrate_quant_scales(mlp, tf, flow_model="transformer", max_flip_rate=None)
    log(f"[int8] transformer full table {tf_table.fingerprint} ({len(tf_table.entries)} layers: "
        f"{', '.join(tf_table.names())}) calibrated on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    tf_int8 = RuntimeConfig(quantize=True, quant_scales=tf_table)
    log("[pipeline] int8, 8k table, batch 1024, 256 drained flows/step, transformer, 64 steps")
    pipe = OctopusPipeline(mlp, tf, PipelineConfig(**tf_pipe), config=tf_int8)
    _, tf_stats = drive_pipeline(kernels, record_routes, pipe, batches, tf_layers,
                                 TF_PLACEMENT, quantized=True)
    if profile:
        profile_steps(torch, pipe, batches[:8], tf_stats.step_us)

    # -- 9. card vs CPU: the transformer (f32, int8) and the unfused CNN
    steps = 64
    cpu_batches = make_batches(TrafficConfig, TrafficGenerator, TRAFFIC, steps, "cpu")
    for label, params, pcfg, rcfg, tol in (
            ("transformer f32", tf, tf_pipe, RuntimeConfig(), TF_LOGIT_TOL["f32"]),
            ("transformer int8", tf, tf_pipe, tf_int8, TF_LOGIT_TOL["int8"]),
            ("cnn unfused", cnn, PIPE, unfused, None)):
        log(f"[card vs cpu] {label}, ordinary traffic, {steps} steps")
        pipes = (OctopusPipeline(mlp, params, PipelineConfig(**pcfg), config=rcfg),
                 OctopusPipeline(mlp, params, PipelineConfig(**pcfg), config=rcfg, device="cpu"))
        res = compare_runs(torch, ft, fx, pipes, cpu_batches, label, logit_tol=tol)
        drained = pipes[1].stats.flows
        text = (f"  tracker state and drained rows bit-identical over {steps} steps "
                f"({drained} flows drained); decisions identical except {res['flipped']} of "
                f"{res['near']} near ties")
        if tol is not None:
            text += (f"; flow logits within {tol} x max|logit|: {res['rows_differ']} of "
                     f"{drained} drained rows not bit-identical, max difference "
                     f"{res['max_err']:.3e} ({res['max_rel']:.3e} of max|logit|)")
        log(text)
        if drained == 0:
            raise AssertionError(f"{label}: no flow drained")

    # -- 10. placement reports
    for label, params, pcfg in (("cnn", cnn, PIPE), ("transformer", tf, tf_pipe)):
        log(f"[plan] {label}")
        log(OctopusPipeline(mlp, params, PipelineConfig(**pcfg)).explain())

    # -- 11. records
    source = {name: f"src/repro_torch/csrc/{name}.cu" for name in results}
    replaces = {"flow_update": "src/repro/kernels/flow_features/flow_features.py:78",
                "vpe_mm": "src/repro/kernels/vpe_smallmm/vpe_smallmm.py:73",
                "mm_fused": "src/repro/kernels/arype_matmul/arype_matmul.py:103",
                "vpe_mm_q": "src/repro/kernels/vpe_smallmm/vpe_smallmm.py:104",
                "mm_fused_q": "src/repro/kernels/arype_matmul/arype_matmul.py:141",
                "mm_unfused_partials": "src/repro/kernels/arype_matmul/arype_matmul.py:170"}
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
