#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # from the root of a checkout, on a machine with one card
    python3 chip_smoke.py --profile  # also trace 8 steps of the f32/int8 CNN and transformer
                                     # pipelines and a short LM serve for the device-busy share

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
     wrapper's 128-deep ones, and its sum pass alone; ``mm_fused`` also at
     the LM's decode and longest-prefill shapes, per forward beside
     ``torch.matmul`` (L2-hot: 20 calls a shape on one weight), each shape's
     plan logged (variant, tile, K ranks C), a 3xTF32 shape bounded by its
     3 x 2MKN tf32 products with the f32 FMA bound beside; then one decode
     forward's 197 matmuls over 28 distinct layers' weights (2.4 GB, cold
     L2), one call each in forward order, beside ``torch.matmul`` run the
     same way and the bound.  Each pipeline phase and the serve check that their
     matmuls are the shapes checked here.  ``[flash]``:
     ``flash_fwd`` against its plain twin in f32 (rtol = atol 2e-5) and bf16
     (rtol 2^-7, one bf16 step; atol 1e-5) over every mask, ragged Sq/Sk, kv_len < Sk, fully masked rows
     (exactly 0), GQA and D 8-256, then at the LM phase's prefill shapes,
     with times of the kernel, the twin and ``scaled_dot_product_attention``;
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
     transformer pipelines;
 11. ``[lm]``: LM serving, qwen3-0.6b at full width and depth in f32 compute
     with seeded port-initialised weights: ``ServeEngine`` (4 slots, 512
     cache rows) serves 8 requests of 16-300 prompt tokens and 32 new tokens;
     every request's tokens equal its single-request greedy run, and the
     launch counts equal the prediction (197 ``mm_fused`` a forward, 28
     ``flash_fwd`` a prefill); prefill ms, decode ms a step and tok/s;
 12. ``[lm card vs cpu]``: one 160-token request through ``LM.prefill`` and
     4 ``decode_step``s on the card and on the CPU, logits within
     ``LM_LOGIT_TOL`` of max|logit|, tokens identical except counted near ties.

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
CARD = "cuda"  # the device of the flash and LM phases
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
TF32_OPS_PER_S = 495e12  # H100 SXM data sheet, dense tf32 tensor-core rate
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
# the LM serving path: qwen3-0.6b at full width and depth, f32 compute,
# port-initialised weights; 8 requests with prompts of 16-300 tokens (some past
# the 128-row flash block), 32 new tokens each, 4 slots of 512 cache rows
LM_ARCH = "qwen3-0.6b"
LM_SERVE = dict(batch_slots=4, cache_len=512)
LM_REQUESTS, LM_MAX_NEW, LM_PROMPT = 8, 32, (16, 300)
LM_CPU_PROMPT, LM_CPU_DECODES = 160, 4
# LM logits, card against CPU, as a share of max|logit|.  The f32 matmuls sum
# in another order on each device (last bits, ~1e-6 of a value), and 28
# layers carry that forward; decode then reads the bf16 KV cache, where a
# last-bit difference in an f32 key or value can round it to the neighbouring
# bf16 value, a step of 2^-8 of it.  1e-3 leaves room for a few such steps
# in the attention sums; near ties of the argmax under it are counted.
LM_LOGIT_TOL = 1e-3
# flash_fwd against its plain twin, (rtol, atol).  f32: the reference test's
# 2e-5, for the order of the sums and exp.  bf16: both sides compute in f32
# and round the output once, so they differ by at most one bf16 step of the
# value, 2^-7 of it at most, plus the f32 differences near 0 (the worst
# reading was 3.9e-3, one step at a value in [0.5, 1)).
FLASH_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2.0**-7, 1e-5)}
BF16_OPS_PER_S = 989e12  # H100 SXM data sheet, dense bf16 tensor-core rate
# (b, hq, hkv, sq, sk, d, mask, window, kv_len): the reference test's sweep
# (masks, GQA, ragged 300), kv_len < Sk, fully masked rows (local window with
# kv_len 5: rows 25.. see no key), and D 8 to 256
FLASH_CASES = [(2, 4, 2, 256, 256, 32, "causal", 0, None), (1, 4, 1, 128, 384, 16, "full", 0, None),
               (2, 2, 2, 300, 300, 32, "local", 64, None), (1, 8, 4, 256, 512, 64, "causal", 0, None),
               (1, 2, 2, 64, 64, 128, "local", 16, None), (1, 4, 1, 128, 384, 16, "full", 0, 200),
               (1, 4, 1, 77, 190, 256, "local", 20, 5), (1, 2, 2, 50, 70, 8, "full", 0, 33)]
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


def check_matmuls(torch, engine, plain, shapes, gen, plan=None) -> dict:
    """Kernel vs plain on the card at each shape (all four activations at the
    first), and per-step times summed over the shapes.  With ``plan``
    (``card_plan``) each shape's plan is logged, and a shape on the 3xTF32
    variant is bounded by its 3 x 2MKN tf32 products over the tensor cores'
    rate (or its bytes), with the f32 FMA bound beside it (``fma_bound_ms``)."""
    err, ms, plain_ms, lib_ms, bound_ms, ops, nbytes = 0.0, 0.0, 0.0, 0.0, 0.0, 0, 0
    fma_bound_ms, ops_ms, rel = 0.0, 0.0, 0.0
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
            rel = max(rel, (out - ref).abs().max().item() / ref.abs().max().item())
        t = time_ms(lambda: engine(x, w))
        tp = time_ms(lambda: plain(x, w))
        tl = time_ms(lambda: torch.matmul(x, w))
        work_bytes, work_ops, rate = 4 * (m * k + k * n + m * n), 2 * m * k * n, F32_OPS_PER_S
        b_fma, _ = bound(work_bytes, work_ops)
        how = ""
        if plan is not None:
            p = plan(x.device, m, k, n)
            how = f" [{p.variant} {p.bm}x{p.bn} C={p.split}]"
            if p.variant == "tf32x3":
                work_ops, rate = 3 * work_ops, TF32_OPS_PER_S
        b, _ = bound(work_bytes, work_ops, rate)
        beside = f" (f32 FMA bound {b_fma:.6f} ms)" if rate != F32_OPS_PER_S else ""
        log(f"  {engine.__name__} {name} ({m},{k},{n}){how}: kernel {t:.5f} ms, plain {tp:.5f} "
            f"ms, torch.matmul {tl:.5f} ms, bound {b:.6f} ms{beside}")
        ms, plain_ms, lib_ms, bound_ms = ms + t, plain_ms + tp, lib_ms + tl, bound_ms + b
        fma_bound_ms += b_fma
        ops_ms += work_ops / rate * 1e3
        ops += 2 * m * k * n
        nbytes += work_bytes
    by = "bytes" if nbytes / HBM_BYTES_PER_S * 1e3 >= ops_ms else "operations"
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=by, library_ms=lib_ms, fma_bound_ms=fma_bound_ms, max_rel_err=rel,
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


def check_partials_sum(torch, arype, gen, bk: int) -> dict:
    """The unfused matmul's sum pass alone (``partials_sum``) against its
    plain version at the loop's unfused shapes, within MATMUL_RTOL, with
    ``torch.sum`` over the partials as the library yardstick."""
    err, ms, plain_ms, lib_ms, bound_ms, ops, nbytes = 0.0, 0.0, 0.0, 0.0, 0.0, 0, 0
    for name, m, k, n in UNFUSED_SHAPES:
        nk = -(-k // bk)
        parts = torch.randn(nk, m, n, generator=gen).to(CARD)
        for act in ACTS:
            out, ref = arype.partials_sum(parts, activation=act), arype.sum_partials(parts, act)
            torch.cuda.synchronize()
            tol = MATMUL_RTOL * ref.abs().max().item()
            if not torch.allclose(out, ref, rtol=MATMUL_RTOL, atol=tol):
                raise AssertionError(f"partials_sum {name} {act}: max err "
                                     f"{(out - ref).abs().max().item()} over tol {tol}")
            err = max(err, (out - ref).abs().max().item())
        t = time_ms(lambda: arype.partials_sum(parts))
        tp = time_ms(lambda: arype.sum_partials(parts, "none"))
        tl = time_ms(lambda: torch.sum(parts, dim=0))
        work_bytes, work_ops = 4 * (nk * m * n + m * n), (nk - 1) * m * n
        b, _ = bound(work_bytes, work_ops)
        log(f"  mm_partials_sum {name} ({nk} partials of ({m},{n})): kernel {t:.5f} ms, plain "
            f"{tp:.5f} ms, torch.sum {tl:.5f} ms, bound {b:.6f} ms")
        ms, plain_ms, lib_ms, bound_ms = ms + t, plain_ms + tp, lib_ms + tl, bound_ms + b
        ops, nbytes = ops + work_ops, nbytes + work_bytes
    _, by = bound(nbytes, ops)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                library_ms=lib_ms, bytes=nbytes, flops=ops)


def flash_case(torch, fa, gen, case, dtype, *, lm_layout: bool = False) -> dict:
    """``flash_attention`` against its plain twin on the card for one case
    (``FLASH_CASES`` layout) within ``FLASH_TOL``; fully masked rows must be
    exactly 0.  ``lm_layout`` makes q, k, v strided views of (B, S, H, D), as
    the LM hands them over.  Times the kernel, the plain twin and
    ``scaled_dot_product_attention`` (the library yardstick: ``is_causal``, or
    a boolean mask), and computes the bound from the valid (query, key) pairs."""
    import torch.nn.functional as F

    b, hq, hkv, sq, sk, d, mask, window, kv_len = case
    dt = getattr(torch, dtype)

    def rand(h, s):
        shape = (b, s, h, d) if lm_layout else (b, h, s, d)
        t = torch.randn(*shape, generator=gen).to(CARD, dt)
        return t.transpose(1, 2) if lm_layout else t

    q, k, v = rand(hq, sq), rand(hkv, sk), rand(hkv, sk)
    kw = dict(mask=mask, window=window, kv_len=kv_len)
    out, ref = fa.flash_attention(q, k, v, **kw), fa.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    rtol, atol = FLASH_TOL[dtype]
    err = (out.float() - ref.float()).abs().max().item()
    if not torch.allclose(out.float(), ref.float(), rtol=rtol, atol=atol):
        raise AssertionError(f"flash_fwd {case} {dtype}: max err {err} over rtol {rtol}, "
                             f"atol {atol}")
    valid = fa.valid_pairs(mask, window, sk if kv_len is None else kv_len,
                           torch.arange(sq, device=CARD)[:, None], torch.arange(sk, device=CARD)[None])
    dead = ~valid.any(dim=1)
    if not torch.equal(out[:, :, dead], torch.zeros_like(out[:, :, dead])):
        raise AssertionError(f"flash_fwd {case} {dtype}: a fully masked row is not exactly 0")
    t = time_ms(lambda: fa.flash_attention(q, k, v, **kw))
    tp = time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), calls=5)
    sdpa = (dict(is_causal=True) if mask == "causal" and kv_len is None
            else dict(attn_mask=valid))
    tl = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=hq != hkv, **sdpa))
    pairs = int(valid.sum())
    nbytes = q.element_size() * (q.numel() + k.numel() + v.numel() + out.numel())
    flops = 4 * b * hq * d * pairs
    bd, by = bound(nbytes, flops, BF16_OPS_PER_S if dtype == "bfloat16" else F32_OPS_PER_S)
    log(f"  flash_fwd B{b} Hq{hq} Hkv{hkv} Sq{sq} Sk{sk} D{d} {mask} w{window} kv_len {kv_len} "
        f"{dtype}{' (LM layout)' if lm_layout else ''}: max err {err:.3e}, "
        f"{int(dead.sum())} fully masked rows exact 0; kernel {t:.5f} ms, plain {tp:.5f} ms, "
        f"sdpa {tl:.5f} ms, bound {bd:.6f} ms ({by})")
    return dict(max_abs_err=err, ms=t, plain_ms=tp, library_ms=tl, bound_ms=bd, bytes=nbytes,
                flops=flops)


def check_flash(torch, fa, gen, prompt_lens, cfg) -> dict:
    """Every case of ``FLASH_CASES`` in f32 and bf16, then the LM phase's own
    prefill shapes (one per prompt length: B = the slots, causal, f32, LM
    layout).  The record sums one call at each LM shape (one layer's flash
    calls over the serve run's prefills)."""
    err = 0.0
    for case in FLASH_CASES:
        for dtype in ("float32", "bfloat16"):
            err = max(err, flash_case(torch, fa, gen, case, dtype)["max_abs_err"])
    slots, hd = LM_SERVE["batch_slots"], cfg.head_dim
    rec = dict(max_abs_err=err, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               bytes=0, flops=0)
    log(f"[flash] the LM's prefill shapes ({LM_ARCH}: {slots} slots, {cfg.num_heads} heads over "
        f"{cfg.num_kv_heads} KV heads, D {hd})")
    for p in prompt_lens:
        case = (slots, cfg.num_heads, cfg.num_kv_heads, p, p, hd, "causal", 0, None)
        r = flash_case(torch, fa, gen, case, "float32", lm_layout=True)
        rec["max_abs_err"] = max(rec["max_abs_err"], r["max_abs_err"])
        for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes", "flops"):
            rec[key] += r[key]
    _, rec["bound_by"] = bound(rec["bytes"], rec["flops"])
    log(f"  over the {len(prompt_lens)} prefill shapes, one call each: kernel {rec['ms']:.5f} ms, "
        f"plain {rec['plain_ms']:.5f} ms, sdpa {rec['library_ms']:.5f} ms, bound "
        f"{rec['bound_ms']:.6f} ms; a prefill runs {cfg.num_layers} such calls")
    return rec


def lm_matmul_shapes(cfg, rows: int) -> list:
    """(name, m, k, n) of one LM forward's routed matmuls over ``rows``
    token rows: a layer's seven, then the lm head on the last positions."""
    slots, d, f = LM_SERVE["batch_slots"], cfg.d_model, cfg.d_ff
    layer = [("wq", d, cfg.q_dim), ("wk", d, cfg.kv_dim), ("wv", d, cfg.kv_dim),
             ("wo", cfg.q_dim, d), ("wi_gate", d, f), ("wi_up", d, f), ("wo_mlp", f, d)]
    return ([(name, rows, k, n) for name, k, n in layer]
            + [("lm_head", slots, d, cfg.padded_vocab)])


def check_lm_matmuls(torch, arype, gen, cfg, longest: int) -> None:
    """``mm_fused`` against its plain twin at the LM's shapes: a decode
    forward (one row a slot) and the longest prompt's prefill, each shape
    timed L2-hot (20 back-to-back calls on one weight), and per forward (28
    layers and the head) from those times; then one decode forward cold."""
    slots = LM_SERVE["batch_slots"]
    for label, rows in (("decode", slots), (f"prefill of {longest} tokens", slots * longest)):
        *layer, head = lm_matmul_shapes(cfg, rows)
        log(f"[kernels] mm_fused at the {LM_ARCH} {label} shapes (L2-hot: 20 calls a shape "
            f"on one weight)")
        a, b = (check_matmuls(torch, arype.arype_matmul, arype.mm_fused, shapes, gen,
                              plan=arype.card_plan)
                for shapes in (layer, [head]))
        per = {key: cfg.num_layers * a[key] + b[key]
               for key in ("ms", "library_ms", "bound_ms", "fma_bound_ms")}
        log(f"  per {label} forward ({cfg.num_layers} layers + lm head, L2-hot): kernel "
            f"{per['ms']:.4f} ms, torch.matmul {per['library_ms']:.4f} ms "
            f"({per['ms'] / per['library_ms']:.2f}x), bound {per['bound_ms']:.4f} ms "
            f"(f32 FMA bound {per['fma_bound_ms']:.4f} ms); worst error "
            f"{max(a['max_rel_err'], b['max_rel_err']):.3e} of max|ref|")
    time_decode_forward_cold(torch, arype, cfg)


def time_decode_forward_cold(torch, arype, cfg) -> None:
    """One decode forward's matmuls as the serve runs them: 7 a layer over
    ``num_layers`` distinct layers' weights and the head (2.4 GB of f32 at
    qwen3-0.6b, far past the 50 MB L2), one call each in forward order,
    behind the sleep kernel, median of 5; the kernel and ``torch.matmul``
    the same way, beside the bound of reading every weight once."""
    slots = LM_SERVE["batch_slots"]
    *layer, head = lm_matmul_shapes(cfg, slots)
    g = torch.Generator(device=CARD).manual_seed(1)
    xs = {k: torch.randn(slots, k, generator=g, device=CARD) for _, _, k, _ in layer + [head]}
    calls = [(xs[k], torch.randn(k, n, generator=g, device=CARD))
             for _ in range(cfg.num_layers) for _, _, k, n in layer]
    calls.append((xs[head[2]], torch.randn(head[2], head[3], generator=g, device=CARD)))
    nbytes = sum(4 * (x.numel() + w.numel() + x.shape[0] * w.shape[1]) for x, w in calls)

    def forward(mm):
        for x, w in calls:
            mm(x, w)

    # 197 enqueues take a few ms of host time: the sleep must outlast them
    t = time_ms(lambda: forward(arype.arype_matmul), calls=1, sleep_cycles=200_000_000)
    tl = time_ms(lambda: forward(torch.matmul), calls=1, sleep_cycles=200_000_000)
    b, by = bound(nbytes, sum(2 * x.shape[0] * x.shape[1] * w.shape[1] for x, w in calls))
    # a launch that reads no weight: what a skinny call costs beyond its bytes
    x0, w0 = torch.empty(slots, 0, device=CARD), torch.empty(0, cfg.d_model, device=CARD)
    floor = time_ms(lambda: arype.arype_matmul(x0, w0))
    log(f"[kernels] mm_fused decode forward, cold L2 ({len(calls)} matmuls over "
        f"{cfg.num_layers} distinct layers + head, {nbytes / 1e9:.3f} GB, one call each): "
        f"kernel {t:.4f} ms, torch.matmul {tl:.4f} ms ({t / tl:.2f}x), bound {b:.4f} ms "
        f"({by}), {nbytes / t / 1e6:.1f} GB/s; a call with K = 0 at ({slots},0,"
        f"{cfg.d_model}) {floor * 1e3:.2f} us")
    del calls, xs
    torch.cuda.empty_cache()


def greedy_single(torch, model, params, prompt, max_new: int, cache_len: int) -> list:
    """The single-request greedy reference: batch 1, prefill then decode."""
    cache = model.init_cache(1, cache_len)
    v = model.cfg.vocab_size
    logits, cache = model.prefill(params, {"tokens": torch.as_tensor(prompt[None]).to(CARD)},
                                  cache)
    toks = [int(torch.argmax(logits[0, -1, :v]))]
    for _ in range(max_new - 1):
        tok = torch.tensor([[toks[-1]]], device=CARD)
        logits, cache = model.decode_step(params, {"tokens": tok}, cache)
        toks.append(int(torch.argmax(logits[0, 0, :v])))
    return toks


def serve_lm(torch, kernels, record_routes, lm_mod, serving, cfg, params, prompts) -> dict:
    """Serve the requests with every launch count at 0 just before and read
    just after; tokens must equal each request's single-request greedy run,
    and launches the prediction: 7 routed matmuls a layer plus the lm head a
    forward, every one on the AryPE at these shapes (``mm_fused``), one
    forward a prefill and one a decode step (every 4-slot wave of
    ``LM_MAX_NEW``-token requests takes ``LM_MAX_NEW - 1`` steps), and one
    ``flash_fwd`` a layer a prefill."""
    refs = [greedy_single(torch, lm_mod.LM(cfg, device=CARD), params, p, LM_MAX_NEW,
                          LM_SERVE["cache_len"]) for p in prompts]
    eng = serving.ServeEngine(cfg, params, serving.ServeConfig(**LM_SERVE), device=CARD)
    reqs = [serving.Request(rid=i, prompt=p, max_new=LM_MAX_NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    kernels.reset_launches()
    with record_routes() as routes:
        done = eng.run_until_drained()
    counts = kernels.launches()
    st = eng.stats
    if len(done) != len(reqs):
        raise AssertionError(f"{len(done)} of {len(reqs)} requests finished")
    for r, ref in zip(reqs, refs):
        if r.out_tokens != ref:
            raise AssertionError(f"request {r.rid}: engine {r.out_tokens} != single {ref}")
    waves = -(-len(reqs) // LM_SERVE["batch_slots"])
    per_forward = 7 * cfg.num_layers + 1
    forwards = len(reqs) + waves * (LM_MAX_NEW - 1)
    want = dict.fromkeys(kernels.KERNELS, 0)
    want["mm_fused"] = per_forward * forwards
    want["flash_fwd"] = cfg.num_layers * len(reqs)
    checked = {(k, n) for _, _, k, n in lm_matmul_shapes(cfg, 1)}
    if {(r.k, r.n) for r in routes} != checked:
        raise AssertionError(f"the serve's matmuls {sorted({(r.k, r.n) for r in routes})} "
                             f"are not the checked {sorted(checked)}")
    recorded = kernels.matmul_launches(routes)
    recorded["flash_fwd"] = cfg.num_layers * st.prefills
    if counts != want or recorded != want or st.prefills + st.decode_steps != forwards:
        raise AssertionError(f"launches {counts}, recorded routes {recorded}, "
                             f"{st.prefills} prefills + {st.decode_steps} decode steps: "
                             f"predicted {want} over {forwards} forwards")
    log(f"  {len(done)}/{len(reqs)} requests done, tokens equal to each one's single-request "
        f"greedy run; {st.prefills} prefills, {st.decode_steps} decode steps, {st.tokens} tokens")
    log(f"  prefill {st.prefill_s / st.prefills * 1e3:.3f} ms per admit (4-slot batch, prompts "
        f"{min(map(len, prompts))}-{max(map(len, prompts))}), decode "
        f"{st.decode_s / st.decode_steps * 1e3:.3f} ms per step, {st.tok_per_s:.1f} generated tok/s")
    log(f"  launches {counts} = predicted: {per_forward} mm_fused a forward x {forwards} "
        f"forwards, {cfg.num_layers} flash_fwd a prefill x {len(reqs)}")
    return counts


def profile_serve(torch, serving, cfg, params, prompts) -> None:
    """Device-busy share of a short serve run from a torch.profiler trace,
    against the run's wall time: the host/device split."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng = serving.ServeEngine(cfg, params, serving.ServeConfig(**LM_SERVE), device=CARD)
    for i, p in enumerate(prompts):
        eng.submit(serving.Request(rid=i, prompt=p, max_new=8))
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.run_until_drained()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us == 0:
        log("[profile] the trace holds no device time: idle share not measured")
        return
    log(f"[profile] serve {len(prompts)} requests x 8 tokens: device busy {busy_us:.1f} us of "
        f"{wall_us:.1f} us traced wall, idle share {1 - busy_us / wall_us:.4f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total:11.1f} us  {e.count:6d} calls  {e.key[:90]}")


def lm_card_vs_cpu(torch, lm_mod, cfg, params, rng) -> None:
    """One request, batch 1: prefill of a ``LM_CPU_PROMPT``-token prompt and
    ``LM_CPU_DECODES`` decode steps on the card and on the CPU (plain
    twins), both fed the CPU's greedy tokens.  Logits within LM_LOGIT_TOL of
    max|logit|; the two argmaxes equal except where the CPU's top two logits
    are that close (counted)."""
    cpu_params = _tree_to(params, "cpu")
    models = (lm_mod.LM(cfg, device=CARD), lm_mod.LM(cfg, device="cpu"))
    caches = [m.init_cache(1, LM_SERVE["cache_len"]) for m in models]
    tokens = rng.integers(0, cfg.vocab_size, (1, LM_CPU_PROMPT))
    worst, ties = 0.0, 0
    for step in range(1 + LM_CPU_DECODES):
        run = "prefill" if step == 0 else "decode_step"
        out = []
        for i, (m, p) in enumerate(zip(models, (params, cpu_params))):
            logits, caches[i] = getattr(m, run)(p, {"tokens": torch.as_tensor(tokens).to(m.device)},
                                                caches[i])
            out.append(logits[0, -1, :cfg.vocab_size].float().cpu())
        g, c = out
        if not (torch.isfinite(g).all() and g.shape == (cfg.vocab_size,)):
            raise AssertionError(f"{run} {step}: card logits not finite or of shape {g.shape}")
        scale = c.abs().max().item()
        rel = (g - c).abs().max().item() / scale
        worst = max(worst, rel)
        top2 = c.topk(2).values
        tie = (top2[0] - top2[1]).item() < LM_LOGIT_TOL * scale
        if rel > LM_LOGIT_TOL:
            raise AssertionError(f"{run} {step}: logits differ by {rel:.3e} of max|logit|")
        if int(g.argmax()) != int(c.argmax()):
            if not tie:
                raise AssertionError(f"{run} {step}: tokens {int(g.argmax())} != {int(c.argmax())}")
            ties += 1
        log(f"  {run} {step}: max|card - cpu| {rel:.3e} of max|logit| ({scale:.4f}), token "
            f"card {int(g.argmax())} cpu {int(c.argmax())}")
        tokens = c.argmax().reshape(1, 1).numpy()
    log(f"  worst {worst:.3e} of max|logit| (tolerance {LM_LOGIT_TOL}); tokens identical "
        f"except {ties} near ties")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def main() -> int:
    import numpy as np
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
    from repro_torch import serving
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import transformer as lm_mod
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
        "mm_fused": check_matmuls(torch, arype.arype_matmul, arype.mm_fused, ARYPE_SHAPES, gen,
                                  plan=arype.card_plan),
        "vpe_mm_q": check_quant_matmuls(torch, vpe_matmul_q, vpe_mm_q, VPE_SHAPES, gen),
        "mm_fused_q": check_quant_matmuls(torch, arype.arype_matmul_q, arype.mm_fused_q,
                                          ARYPE_SHAPES, gen),
        "mm_unfused_partials": check_unfused(torch, arype, UNFUSED_SHAPES, gen, UNFUSED_BK),
        "mm_partials_sum": check_partials_sum(torch, arype, gen, UNFUSED_BK),
    }
    lm_cfg = get_config(LM_ARCH).replace(compute_dtype="float32")
    lm_rng = np.random.default_rng(0)
    prompts = [lm_rng.integers(0, lm_cfg.vocab_size, n)
               for n in lm_rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, LM_REQUESTS)]
    check_lm_matmuls(torch, arype, gen, lm_cfg, max(len(p) for p in prompts))
    log("[flash] flash_fwd against its plain twin on the card")
    results["flash_fwd"] = check_flash(torch, fa, gen, [len(p) for p in prompts], lm_cfg)
    log("[kernels] mm_fused and mm_fused_q at the transformer flow engine's shapes")
    for name, engine, plain, check, kw in (
            ("mm_fused", arype.arype_matmul, arype.mm_fused, check_matmuls,
             dict(plan=arype.card_plan)),
            ("mm_fused_q", arype.arype_matmul_q, arype.mm_fused_q, check_quant_matmuls, {})):
        r = check(torch, engine, plain, TF_ARYPE_SHAPES, gen, **kw)
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], r["max_abs_err"])
        log(f"  {name} per transformer step (6 layers): kernel {r['ms']:.5f} ms, plain "
            f"{r['plain_ms']:.5f} ms, library {r['library_ms']} ms, bound {r['bound_ms']:.6f} ms")
    log(f"  mm_fused worst error over the pipeline shapes: "
        f"{results['mm_fused']['max_rel_err']:.3e} of max|ref|")
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
    counts["mm_partials_sum"] = u_counts["mm_partials_sum"]
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

    # -- 11. LM serving: qwen3-0.6b at full width and depth
    t0 = time.perf_counter()
    lm_params = lm_mod.LM(lm_cfg, device=CARD).init(torch.Generator(device=CARD).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(lm_params))
    log(f"[lm] {LM_ARCH}, f32 compute, {n_params} port-initialised parameters (seed 0) in "
        f"{time.perf_counter() - t0:.2f} s; ServeConfig({LM_SERVE}), {LM_REQUESTS} requests, "
        f"prompts {sorted(len(p) for p in prompts)}, max_new {LM_MAX_NEW}")
    counts["flash_fwd"] = serve_lm(torch, kernels, record_routes, lm_mod, serving, lm_cfg,
                                   lm_params, prompts)["flash_fwd"]
    if profile:
        profile_serve(torch, serving, lm_cfg, lm_params, prompts[:4])

    # -- 12. LM card vs CPU
    log(f"[lm card vs cpu] batch 1, a {LM_CPU_PROMPT}-token prompt, prefill + {LM_CPU_DECODES} "
        f"decode steps at full depth")
    lm_card_vs_cpu(torch, lm_mod, lm_cfg, lm_params, lm_rng)

    # -- 13. records
    source = {name: f"src/repro_torch/csrc/{name}.cu" for name in results}
    source["mm_partials_sum"] = "src/repro_torch/csrc/mm_unfused_partials.cu"
    replaces = {"flow_update": "src/repro/kernels/flow_features/flow_features.py:78",
                "vpe_mm": "src/repro/kernels/vpe_smallmm/vpe_smallmm.py:73",
                "mm_fused": "src/repro/kernels/arype_matmul/arype_matmul.py:103",
                "vpe_mm_q": "src/repro/kernels/vpe_smallmm/vpe_smallmm.py:104",
                "mm_fused_q": "src/repro/kernels/arype_matmul/arype_matmul.py:141",
                "mm_unfused_partials": "src/repro/kernels/arype_matmul/arype_matmul.py:170",
                # the ablation's second pass, the aggregation of the partials
                "mm_partials_sum": "src/repro/kernels/arype_matmul/ops.py:105",
                "flash_fwd": "src/repro/kernels/flash_attention/flash_attention.py:105"}
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
