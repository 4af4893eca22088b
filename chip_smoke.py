#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # from the root of a checkout, on a machine with one card
    python3 chip_smoke.py --profile  # also trace 8 steps of the f32/int8 CNN and transformer
                                     # pipelines and a short LM serve for the device-busy share
    python3 chip_smoke.py --kernel-times [--src DIR] [--label NAME]
                                     # only time the engine and flash kernels (see kernel_times)

Phases, each of which fails the run (non-zero exit) when it fails:

  1. the card's name and power limit, and the build of the kernel library
     from ``src/repro_torch/csrc`` (nvcc, sm_90a);
  2. every kernel of the pipeline's paths against its plain PyTorch version
     on the card, at the shapes the pipeline gives it (``flow_update`` exact,
     the f32 matmuls within rtol 1e-5, atol 1e-5 * max|ref|, the int8
     matmuls ``vpe_mm_q``/``mm_fused_q`` bit for bit under none/relu with
     per-tensor and per-channel weight scales), with times of the kernel,
     the plain version and one PyTorch library call; ``mm_fused``/``mm_fused_q``
     also at the transformer flow engine's shapes (``mm_fused_q`` beside
     ``torch._int_mm`` summed over the shapes cuBLASLt takes);
     ``mm_unfused_partials`` (partials pass and sum pass) also at use-case 2's
     ``arype_only`` shapes for 1000 flows, with the paper's 32-deep K blocks
     and the reference wrapper's 128-deep ones, and its sum pass alone; each
     ``mm_fused_q`` and ``mm_unfused_partials`` shape's plan (tile, grid)
     logged; ``mm_fused`` also at
     the LM's decode and longest-prefill shapes, per forward beside
     ``torch.matmul`` (L2-hot: 20 calls a shape on one weight), each shape's
     plan logged (variant, tile, K ranks C), a 3xTF32 shape bounded by its
     3 x 2MKN tf32 products with the f32 FMA bound beside; then one decode
     forward's 197 matmuls over 28 distinct layers' weights (2.4 GB, cold
     L2), one call each in forward order, beside ``torch.matmul`` run the
     same way and the bound.  The same LM shapes again through
     ``mm_fused``'s mixed arm (bf16 x on f32 w, bf16 out, the head's f32;
     the registered compute type): bit for bit with the f32 arm on
     ``x.float()``, within one bf16 step of the plain twin, beside
     ``torch.matmul(x.float(), w).to(out)`` and its 2 x 2MKN tf32 bound; the
     bf16 decode forward cold; ``vpe_mm``'s mixed arm at the batch-1 decode
     projections the router places on the VPE, where both arms (M <= 8: the
     AryPE's skinny split-K) equal ``arype_matmul`` bit for bit, and the f32
     arm's time there.  Each pipeline phase and the serve check that their
     matmuls are the shapes checked here.  ``[flash]``: ``flash_fwd`` against
     its plain twin in f32 (the SIMT kernel; rtol = atol 2e-5) and bf16 (the
     tensor-core kernel; rtol 2^-7, one bf16 step; atol 1e-5) over every
     mask, ragged Sq/Sk, kv_len < Sk, fully masked rows (exactly 0), GQA and
     D 8-256, then at the LM phase's prefill shapes in both, with times of
     the kernel, the twin and ``scaled_dot_product_attention`` (a record for
     each type);
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
     ``collaborative`` fused), timed on the card, the unfused logits equal
     to the fused ones bit for bit; ``collaborative_forward``
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
 11. ``[pipeline two-level]``: the CNN f32 loop at the 8k table on traffic of
     65536 live flows (8 a hot slot), 64 steps through ``prefetch``, hot-only
     and with a 2^20-entry cold table (``cold_policy`` "age"), each at
     ``scan_len`` 1 and 4, ``overlap`` off and on, and "lru" at scan_len 1
     eager and scan_len 4 overlapped: launch counts as ``record_routes``
     predicts (``flow_update`` once a step), every mode's tracker state, rule
     table and counters equal the eager run's, spills and promotions happen;
     under both policies the drained rows of every step equal between eager
     steps and scan_len 4 handles, and the first 16 steps equal the CPU's
     (hot and cold leaves, drained rows); step us (host / exposed device),
     cold occupancy, and the host's waits a step (the collision check, the
     cold store's rounds) on this traffic and on a collision attack;
 12. ``[pipeline masked]``: ``warm_bucket`` at 256 and 8192 packets, then
     ``step_masked`` on ragged keep masks at both sizes, card against CPU:
     tracker state and drained rows bit for bit, decisions identical except
     near ties; the 8192 bucket runs ``flow_update``'s chunked variant;
 13. ``[lm]``: LM serving, qwen3-0.6b at full width and depth in f32 compute
     with seeded port-initialised weights: ``ServeEngine`` (4 slots, 512
     cache rows) serves 8 requests of 16-300 prompt tokens and 32 new tokens;
     every request's tokens equal its single-request greedy run, and the
     launch counts equal the prediction (197 ``mm_fused`` a forward, 28
     ``flash_fwd`` a prefill); prefill ms, decode ms a step and tok/s;
 14. ``[lm card vs cpu]``: one 160-token request through ``LM.prefill`` and
     4 ``decode_step``s on the card and on the CPU, logits within
     ``LM_LOGIT_TOL`` of max|logit|, tokens identical except counted near ties;
 15. ``[lm bf16]``: qwen3-0.6b as registered (bf16 activations on the same
     f32 weights) serving the same requests: tokens equal, exactly, each
     request served alone at the same 4 slots, and its batch-1 greedy run
     except counted near ties under ``BF16_TIE_GAP`` (batch 1's plain decode
     attention sums in another order); launches as in 13, times beside the
     f32 run's; ``[lm bf16 card vs cpu]`` as 14 within ``BF16_LOGIT_TOL``,
     with the request in all 4 slots held to the batch-1 card run the same
     way, and the f32-compute control's distance printed beside them;
 16. ``[lm gemma3-1b]``: gemma3-1b at full width as registered (head_dim 256,
     the 512-token window, vocab 262144; its embed_scale makes the stack f32)
     serving 4 requests, one past the window: tokens equal the single-request
     runs except counted near ties under ``LM_LOGIT_TOL``, launches as
     predicted (183 ``mm_fused`` a forward, 26 ``flash_fwd`` a prefill).

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
# gemma3-1b at full width and its registered default (bf16 compute, which
# its embed_scale promotes to an f32 stack), 4 slots of 1024 cache rows: one
# prompt past the 512-token window (its local layers' ring caches wrap), one
# just past it, two inside it; 16 new tokens each
GEMMA_ARCH = "gemma3-1b"
GEMMA_SERVE = dict(batch_slots=4, cache_len=1024)
GEMMA_PROMPTS, GEMMA_MAX_NEW = (700, 37, 256, 530), 16
# the two-level table: a 2^20-entry cold bank behind the 8k hot table, on
# traffic of 65536 live flows (8 a hot slot), so evictions spill and return
COLD_SIZE = 1 << 20
SPILL_TRAFFIC = dict(batch_size=1024, active_flows=65536, table_size=8192,
                     collision_free=False, seed=0)
TWO_LEVEL_STEPS, TWO_LEVEL_CPU_STEPS, CHUNK = 64, 16, 4
# masked buckets: a small request batch, and one past flow_update's chunk
BUCKETS, MASKED_STEPS = (256, 8192), 6


# qwen3-0.6b's logits in bf16 compute (28 layers), as shares of max|logit|.
# Two runs of the same bf16 stack whose f32 sums differ in order (the card
# against the CPU; batch 1 against 4 slots, whose matmuls give the same bits
# since the VPE runs mm_fused's skinny kernel at M <= 8, but whose plain
# PyTorch decode attention does not: its f32 sums differ in the last bit
# between batch 1 and 4 on the card) round some values to the other
# neighbouring bf16 value, and the layers carry those flips to the logits.
# ``[lm bf16 card vs cpu]`` prints the readings every run; on an H100 (700 W)
# they were 1.783e-02 card against CPU and 1.497e-02 4 slots against batch 1
# (1.605e-02 once the matmuls agreed), and the limit sits above them.  Its control, the same
# weights and tokens in f32 compute against the CPU's bf16 run, read
# 1.832e-02: inside the sound spread, so at full depth this check sees only
# faults larger than bf16's own noise.  The roundings themselves are held
# by the kernels' bit-for-bit checks and, against the JAX reference, at
# reduced depth (tests/test_torch_bf16.py), where the readings lie 5 orders
# apart.
BF16_LOGIT_TOL = 2.5e-2
# A token of two sound bf16 runs may differ only where the reference run's
# top two logits are closer than this share of max|logit|: the largest gap at
# a differing token seen on an H100 was 1.457e-02 (a batch-1 run against the
# serve), and logits that each move by the 4-slot reading can swap no pair
# farther apart than twice it (3.21e-02 at 1.605e-02).
BF16_TIE_GAP = 2e-2
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


def check_quant_matmuls(torch, engine, plain, shapes, gen, plan=None) -> dict:
    """Int8 kernel vs its plain twin on the card at each shape, with a
    per-tensor and a per-channel weight scale (all four activations at the
    first shape): bit for bit under none/relu, rtol 1e-5 under silu/gelu.
    Times use per-channel scales.  The library yardstick is
    ``torch._int_mm`` on operands quantized beforehand, where cuBLASLt takes
    the shape (M > 16, K and N multiples of 8); the per-step library time is
    null unless every shape has one, and ``taken`` names the shapes that
    have one, with the kernel's (``taken_ms``) and the library's
    (``taken_library_ms``) time summed over them.  With ``plan``
    (``mm_fused_q_plan`` on this card's SMs, ``vpe_q_plan``) each shape's
    tile is logged."""
    from repro_torch.runtime.quant import pick_scale, quantize_i8

    err, ms, plain_ms, lib_ms, bound_ms, ops, nbytes = 0.0, 0.0, 0.0, 0.0, 0.0, 0, 0
    lib_all, taken, taken_ms = True, [], 0.0
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
        if tl is not None:
            taken.append(name)
            taken_ms += t
        work_bytes, work_ops = 4 * (m * k + k * n + m * n), 2 * m * k * n
        b, _ = bound(work_bytes, work_ops, INT8_OPS_PER_S)
        lib = f"{tl:.5f} ms" if tl is not None else "none (shape not taken by cuBLASLt)"
        how = ""
        if plan is not None:
            p = plan(m, k, n)
            how = f" [{p.bm}x{p.bn}, grid {p.grid(m, n)}]"
        log(f"  {engine.__name__} {name} ({m},{k},{n}){how}: kernel {t:.5f} ms, plain {tp:.5f} "
            f"ms, torch._int_mm {lib}, bound {b:.6f} ms")
        ms, plain_ms, bound_ms = ms + t, plain_ms + tp, bound_ms + b
        lib_ms += tl or 0.0
        ops, nbytes = ops + work_ops, nbytes + work_bytes
    _, by = bound(nbytes, ops, INT8_OPS_PER_S)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                library_ms=lib_ms if lib_all else None, bytes=nbytes, flops=ops,
                taken=taken, taken_ms=taken_ms, taken_library_ms=lib_ms)


def check_unfused(torch, arype, shapes, gen, bk: int | None) -> dict:
    """``mm_unfused_partials`` and its sum pass against their plain versions
    on the card at each shape (all four activations at the first): the
    partials and the unfused product within MATMUL_RTOL.  Times are of the
    whole unfused matmul (both launches), its plain version and
    ``torch.matmul`` on the same (M, K, N), summed over the shapes; each
    shape's plan (tile, grid) is logged.  The
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
        p = arype.mm_unfused_plan(m, k, n, depth, arype.sm_count(x.device))
        log(f"  mm_unfused_partials {name} ({m},{k},{n}) bk={depth} "
            f"({nk} partials) [{p.bm}x{p.bn}, grid {p.grid(m, n)}]: kernel {t:.5f} ms, plain "
            f"{tp:.5f} ms, torch.matmul {tl:.5f} ms, bound {b:.6f} ms ({work_bytes} bytes)")
        ms, plain_ms, lib_ms, bound_ms = ms + t, plain_ms + tp, lib_ms + tl, bound_ms + b
        ops, nbytes = ops + work_ops, nbytes + work_bytes
    _, by = bound(nbytes, ops)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                library_ms=lib_ms, bytes=nbytes, flops=ops)


def check_flow_update(torch, ff, gen) -> dict:
    """flow_update vs its plain fold, bit for bit: the default program on
    pipeline-shaped input, a random program whose hist_src crosses lanes with
    every op and wrapping values, long colliding segments, one packet, the
    plan's cap + 1 (the chunked variant) and every slot dropped; each call
    one port kernel launch, its input table untouched.  Times of the wrapper
    and of its kernel alone (on an output allocated once) at the pipeline's
    P and F, spread and colliding."""
    F, P, cap = PIPE["table_size"], PIPE["batch_size"], ff.FLOW_CAP
    rand32 = lambda *shape: torch.randint(-2**31, 2**31, shape, generator=gen,
                                          dtype=torch.int64).to(torch.int32)
    cross = torch.stack([torch.arange(16) % 7, torch.randint(0, 13, (16,), generator=gen),
                         (torch.arange(16) * 5 + 3) % 16], dim=1).to(torch.int32)
    default = ff.default_program("cpu")
    cases = [
        ("default", default, torch.randint(0, F + 1, (P,), generator=gen)),
        ("cross-lane", cross, torch.randint(0, F + 1, (P,), generator=gen)),
        ("colliding", cross, torch.randint(0, 4, (P,), generator=gen)),
        ("one packet", cross, torch.randint(0, F, (1,), generator=gen)),
        (f"cap + 1 ({ff.flow_plan(cap + 1, F).variant})", cross,
         torch.randint(0, F + 1, (cap + 1,), generator=gen)),
        ("all dropped", cross, torch.full((P,), F)),
    ]
    for name, program, slots in cases:
        p = slots.shape[0]
        args = [a.cuda() for a in (program, slots.to(torch.int32), rand32(p, 13), rand32(F, 16))]
        table = args[3].clone()
        ref = ff.flow_feature_update_plain(*args)
        before = ff.FLOW_UPDATE.launches
        out = ff.flow_feature_update(*args)
        launches = ff.FLOW_UPDATE.launches - before
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"flow_update {name}: {(out != ref).sum().item()} lanes differ")
        if launches != 1 or not torch.equal(args[3], table):
            raise AssertionError(f"flow_update {name}: {launches} launches, input table "
                                 f"{'kept' if torch.equal(args[3], table) else 'changed'}")
        log(f"  flow_update {name}: bit-exact over {p} packets, 1 launch, input table kept")
    times = {}
    for name, hi in (("spread", F + 1), ("colliding", 3)):
        args = [a.cuda() for a in (default, torch.randint(0, hi, (P,), generator=gen)
                                   .to(torch.int32), rand32(P, 13), rand32(F, 16))]
        out = torch.empty_like(args[3])
        plan = ff.flow_plan(P, F, torch.cuda.get_device_properties(0).multi_processor_count)
        kernel = lambda: ff.FLOW_UPDATE(out.device, *(a.data_ptr() for a in args),
                                        out.data_ptr(), P, F, ff.META_WIDTH, plan.ctas, plan.cap,
                                        plan.variant == "chunked",
                                        torch.cuda.current_stream().cuda_stream)
        times[name] = (time_ms(lambda: ff.flow_feature_update(*args)), time_ms(kernel))
        log(f"  flow_update {name} (P={P}, F={F}, {plan.variant}, {plan.ctas} CTAs of "
            f"{plan.rows} rows): wrapper {times[name][0]:.6f} ms, 1 launch a call, "
            f"kernel alone {times[name][1]:.6f} ms")
    args = [a.cuda() for a in (default, cases[0][2].to(torch.int32), rand32(P, 13),
                               rand32(F, 16))]
    tp = time_ms(lambda: ff.flow_feature_update_plain(*args), calls=5)
    nbytes = 4 * (16 * 3 + P + 13 * P + 16 * F) + 4 * 16 * F
    b, by = bound(nbytes, 16 * P)  # 32-bit ALU ops at the f32 rate
    log(f"  flow_update (P={P}, F={F}): plain {tp:.5f} ms, bound {b:.6f} ms ({nbytes} bytes)")
    return dict(max_abs_err=0, ms=times["spread"][0], plain_ms=tp, bound_ms=b, bound_by=by,
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


def check_flash(torch, fa, gen, prompt_lens, cfg) -> tuple[dict, dict]:
    """Every case of ``FLASH_CASES`` in f32 and bf16, then the LM phase's own
    prefill shapes (one per prompt length: B = the slots, causal, LM layout)
    in both.  Returns the f32 and the bf16 record (f32 the SIMT kernel, bf16
    the tensor-core one), each summing one call at each LM shape (one
    layer's flash calls over the serve run's prefills)."""
    recs = {dtype: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                        bytes=0, flops=0) for dtype in ("float32", "bfloat16")}
    for case in FLASH_CASES:
        for dtype, rec in recs.items():
            rec["max_abs_err"] = max(rec["max_abs_err"],
                                     flash_case(torch, fa, gen, case, dtype)["max_abs_err"])
    slots, hd = LM_SERVE["batch_slots"], cfg.head_dim
    log(f"[flash] the LM's prefill shapes ({LM_ARCH}: {slots} slots, {cfg.num_heads} heads over "
        f"{cfg.num_kv_heads} KV heads, D {hd})")
    for p in prompt_lens:
        case = (slots, cfg.num_heads, cfg.num_kv_heads, p, p, hd, "causal", 0, None)
        for dtype, rec in recs.items():
            r = flash_case(torch, fa, gen, case, dtype, lm_layout=True)
            rec["max_abs_err"] = max(rec["max_abs_err"], r["max_abs_err"])
            for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes", "flops"):
                rec[key] += r[key]
    for dtype, rec in recs.items():
        _, rec["bound_by"] = bound(rec["bytes"], rec["flops"],
                                   BF16_OPS_PER_S if dtype == "bfloat16" else F32_OPS_PER_S)
        log(f"  {dtype} over the {len(prompt_lens)} prefill shapes, one call each: kernel "
            f"{rec['ms']:.5f} ms, plain {rec['plain_ms']:.5f} ms, sdpa {rec['library_ms']:.5f} "
            f"ms, bound {rec['bound_ms']:.6f} ms ({rec['bound_by']}); a prefill runs "
            f"{cfg.num_layers} such calls; worst error over every case {rec['max_abs_err']:.3e}")
    return recs["float32"], recs["bfloat16"]


def lm_prompts(cfg, rng) -> list:
    """The ``[lm]`` phase's LM_REQUESTS prompts of LM_PROMPT tokens, from ``rng``."""
    return [rng.integers(0, cfg.vocab_size, n)
            for n in rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, LM_REQUESTS)]


def lm_matmul_shapes(cfg, rows: int) -> list:
    """(name, m, k, n) of one LM forward's routed matmuls over ``rows``
    token rows: a layer's seven, then the lm head on the last positions."""
    slots, d, f = LM_SERVE["batch_slots"], cfg.d_model, cfg.d_ff
    layer = [("wq", d, cfg.q_dim), ("wk", d, cfg.kv_dim), ("wv", d, cfg.kv_dim),
             ("wo", cfg.q_dim, d), ("wi_gate", d, f), ("wi_up", d, f), ("wo_mlp", f, d)]
    return ([(name, rows, k, n) for name, k, n in layer]
            + [("lm_head", slots, d, cfg.padded_vocab)])


def bf16_step(torch, v):
    """One bf16 step (ulp) at each |v|: 2^(e - 7) for |v| in [2^e, 2^(e+1))."""
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(2.0**-126))) - 7)


def check_mixed_matmuls(torch, engine, plain, shapes, gen, plan=None) -> dict:
    """The mixed arm (bf16 x on f32 w) at each (name, m, k, n): bf16 out,
    f32 for the ``lm_head`` (all four activations at the first shape).  The
    kernel must equal itself on ``x.float()`` rounded once, bit for bit, and
    lie within one bf16 step (f32 out: rtol 1e-5) of the plain twin.  Times
    of the kernel, the twin and the library call for the same function,
    ``torch.matmul(x.float(), w).to(out)``, summed over the shapes; the bound
    counts 2 bytes of x, 4 of w, 2 or 4 of out over 3.35 TB/s, or the
    operations: 2 x 2MKN tf32 products over 495 TFLOP/s on the tf32x3
    variant (``plan``; the bf16 arm skips the lo*hi product), 2MKN f32 FMAs
    elsewhere."""
    rec = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, ops_ms=0.0,
               bytes=0, flops=0)
    for i, (name, m, k, n) in enumerate(shapes):
        x = torch.randn(m, k, generator=gen).to(CARD, torch.bfloat16)
        w = torch.randn(k, n, generator=gen).to(CARD)
        od = torch.float32 if name == "lm_head" else torch.bfloat16
        for act in (ACTS if i == 0 else ("none",)):
            out = engine(x, w, activation=act, out_dtype=od)
            if not torch.equal(out, engine(x.float(), w, activation=act).to(od)):
                raise AssertionError(f"{engine.__name__} bf16 x {name} {act}: differs from the "
                                     f"f32 arm on x.float()")
            ref = plain(x, w, activation=act, out_dtype=od).float()
            diff = (out.float() - ref).abs()
            top = ref.abs().max()
            ok = (diff <= (bf16_step(torch, ref) if od == torch.bfloat16
                           else MATMUL_RTOL * ref.abs()) + MATMUL_RTOL * top).all()
            if not ok:
                raise AssertionError(f"{engine.__name__} bf16 x {name} {act}: max err "
                                     f"{diff.max().item()} from the plain twin")
            rec["max_abs_err"] = max(rec["max_abs_err"], diff.max().item())
        t = time_ms(lambda: engine(x, w, out_dtype=od))
        tp = time_ms(lambda: plain(x, w, out_dtype=od))
        tl = time_ms(lambda: torch.matmul(x.float(), w).to(od))
        nbytes = 2 * m * k + 4 * k * n + out.element_size() * m * n
        ops, rate, how = 2 * m * k * n, F32_OPS_PER_S, ""
        if plan is not None:
            p = plan(x.device, m, k, n)
            how = f" [{p.variant} {p.bm}x{p.bn} C={p.split}]"
            if p.variant == "tf32x3":
                ops, rate = 2 * ops, TF32_OPS_PER_S
        b, by = bound(nbytes, ops, rate)
        log(f"  {engine.__name__} bf16 x {name} ({m},{k},{n}) -> {str(od)[6:]}{how}: kernel "
            f"{t:.5f} ms, plain {tp:.5f} ms, torch.matmul(x.float(), w).to() {tl:.5f} ms, "
            f"bound {b:.6f} ms ({by})")
        for key, v in (("ms", t), ("plain_ms", tp), ("library_ms", tl), ("bound_ms", b),
                       ("ops_ms", ops / rate * 1e3), ("bytes", nbytes), ("flops", ops)):
            rec[key] += v
    rec["bound_by"] = "bytes" if rec["bytes"] / HBM_BYTES_PER_S * 1e3 >= rec["ops_ms"] \
        else "operations"
    return rec


def check_lm_matmuls(torch, arype, gen, cfg, longest: int) -> dict:
    """``mm_fused`` against its plain twin at the LM's shapes: a decode
    forward (one row a slot) and the longest prompt's prefill, each shape
    timed L2-hot (20 back-to-back calls on one weight), and per forward (28
    layers and the head) from those times, in f32 and in the mixed arm (bf16
    x, the registered compute type); then one decode forward cold in each.
    Returns the mixed arm's record: one decode and one prefill forward."""
    slots = LM_SERVE["batch_slots"]
    mixed = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                 bytes=0, flops=0, ops_ms=0.0)
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
        log(f"[kernels] mm_fused's mixed arm (bf16 x, f32 w) at the {LM_ARCH} {label} shapes, "
            f"each bit for bit with the f32 arm on x.float()")
        a, b = (check_mixed_matmuls(torch, arype.arype_matmul, arype.mm_fused, shapes, gen,
                                    plan=arype.card_plan)
                for shapes in (layer, [head]))
        per = {key: cfg.num_layers * a[key] + b[key]
               for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes", "flops",
                           "ops_ms")}
        log(f"  per {label} forward, bf16 x: kernel {per['ms']:.4f} ms, torch.matmul(x.float(), "
            f"w).to() {per['library_ms']:.4f} ms ({per['ms'] / per['library_ms']:.2f}x), bound "
            f"{per['bound_ms']:.4f} ms; worst error from the twin "
            f"{max(a['max_abs_err'], b['max_abs_err']):.3e}")
        mixed["max_abs_err"] = max(mixed["max_abs_err"], a["max_abs_err"], b["max_abs_err"])
        for key, v in per.items():
            mixed[key] += v
    mixed["bound_by"] = "bytes" if mixed["bytes"] / HBM_BYTES_PER_S * 1e3 >= mixed.pop("ops_ms") \
        else "operations"
    for dtype in ("float32", "bfloat16"):
        time_decode_forward_cold(torch, arype, cfg, dtype)
    return mixed


def check_vpe_mixed(torch, vpe_matmul, vpe_mm, arype_matmul, gen, cfg) -> dict:
    """The VPE's mixed arm at the one-row projections the router places there
    (a batch-1 decode: wq, wk, wv, wo), bit for bit with the f32 arm on
    x.float(), within one bf16 step of the plain twin; both arms bit for bit
    with ``arype_matmul`` (M <= 8 runs the AryPE's skinny split-K with its
    plan); per batch-1 decode forward (the layer's four, ``num_layers``
    times), the mixed arm's record, and the f32 arm's time beside
    ``torch.matmul``."""
    d = cfg.d_model
    shapes = [("wq", 1, d, cfg.q_dim), ("wk", 1, d, cfg.kv_dim), ("wv", 1, d, cfg.kv_dim),
              ("wo", 1, cfg.q_dim, d)]
    log(f"[kernels] vpe_mm's mixed arm (bf16 x, f32 w) at the {LM_ARCH} batch-1 decode "
        f"projections")
    r = check_mixed_matmuls(torch, vpe_matmul, vpe_mm, shapes, gen)
    rec = {key: cfg.num_layers * r[key] if key in ("ms", "plain_ms", "library_ms", "bound_ms")
           else r[key] for key in ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
                                   "bound_by")}
    log(f"  per batch-1 decode forward ({cfg.num_layers} x 4 calls): kernel {rec['ms']:.4f} ms, "
        f"torch.matmul(x.float(), w).to() {rec['library_ms']:.4f} ms, bound "
        f"{rec['bound_ms']:.4f} ms")
    t32 = lib32 = 0.0
    for name, m, k, n in shapes:
        w = torch.randn(k, n, generator=gen).to(CARD)
        x = torch.randn(m, k, generator=gen).to(CARD)
        for xa, od in ((x, torch.float32), (x.bfloat16(), torch.bfloat16),
                       (x.bfloat16(), torch.float32)):
            for act in ACTS:
                if not torch.equal(vpe_matmul(xa, w, activation=act, out_dtype=od),
                                   arype_matmul(xa, w, activation=act, out_dtype=od)):
                    raise AssertionError(f"vpe_mm {name} {xa.dtype} -> {od} {act}: differs "
                                         f"from arype_matmul")
        t32 += time_ms(lambda: vpe_matmul(x, w))
        lib32 += time_ms(lambda: torch.matmul(x, w))
    log(f"  both arms bit for bit with arype_matmul at every shape and activation; the f32 arm "
        f"per batch-1 decode forward: kernel {cfg.num_layers * t32:.4f} ms, torch.matmul "
        f"{cfg.num_layers * lib32:.4f} ms")
    return rec


def time_decode_forward_cold(torch, arype, cfg, dtype: str = "float32") -> None:
    """One decode forward's matmuls as the serve runs them: 7 a layer over
    ``num_layers`` distinct layers' weights and the head (2.4 GB of f32 at
    qwen3-0.6b, far past the 50 MB L2), one call each in forward order,
    behind the sleep kernel, median of 5; the kernel and ``torch.matmul``
    the same way, beside the bound of reading every weight once.  ``dtype``
    is the activations' (bf16: the mixed arm, bf16 out but the head's f32;
    the library call then ``torch.matmul(x.float(), w).to(out)``)."""
    slots = LM_SERVE["batch_slots"]
    dt = getattr(torch, dtype)
    *layer, head = lm_matmul_shapes(cfg, slots)
    g = torch.Generator(device=CARD).manual_seed(1)
    xs = {k: torch.randn(slots, k, generator=g, device=CARD).to(dt)
          for _, _, k, _ in layer + [head]}
    calls = [(xs[k], torch.randn(k, n, generator=g, device=CARD), dt)
             for _ in range(cfg.num_layers) for _, _, k, n in layer]
    calls.append((xs[head[2]], torch.randn(head[2], head[3], generator=g, device=CARD),
                  torch.float32))
    nbytes = sum(x.element_size() * x.numel() + 4 * w.numel()
                 + torch.empty((), dtype=od).element_size() * x.shape[0] * w.shape[1]
                 for x, w, od in calls)

    def forward(mm):
        for x, w, od in calls:
            mm(x, w, od)

    def library(x, w, od):
        return torch.matmul(x, w) if x.dtype == torch.float32 else torch.matmul(x.float(), w).to(od)

    # 197 enqueues take a few ms of host time: the sleep must outlast them
    t = time_ms(lambda: forward(lambda x, w, od: arype.arype_matmul(x, w, out_dtype=od)),
                calls=1, sleep_cycles=200_000_000)
    tl = time_ms(lambda: forward(library), calls=1, sleep_cycles=200_000_000)
    b, by = bound(nbytes, sum(2 * x.shape[0] * x.shape[1] * w.shape[1] for x, w, _ in calls))
    # a launch that reads no weight: what a skinny call costs beyond its bytes
    x0, w0 = torch.empty(slots, 0, device=CARD, dtype=dt), torch.empty(0, cfg.d_model, device=CARD)
    floor = time_ms(lambda: arype.arype_matmul(x0, w0))
    log(f"[kernels] mm_fused decode forward, {dtype} x, cold L2 ({len(calls)} matmuls over "
        f"{cfg.num_layers} distinct layers + head, {nbytes / 1e9:.3f} GB, one call each): "
        f"kernel {t:.4f} ms, {'torch.matmul' if dtype == 'float32' else 'torch.matmul(x.float(), w).to()'} "
        f"{tl:.4f} ms ({t / tl:.2f}x), bound {b:.4f} ms ({by}), {nbytes / t / 1e6:.1f} GB/s; a "
        f"call with K = 0 at ({slots},0,{cfg.d_model}) {floor * 1e3:.2f} us")
    del calls, xs
    torch.cuda.empty_cache()


def greedy_single(torch, model, params, prompt, max_new: int, cache_len: int):
    """The single-request greedy reference: batch 1, prefill then decode.
    Returns its tokens and, at each, the gap of its top two logits as a
    share of max|logit|."""
    cache = model.init_cache(1, cache_len)
    v = model.cfg.vocab_size
    toks, gaps = [], []

    def take(logits):
        top2 = logits.topk(2).values
        gaps.append(((top2[0] - top2[1]) / logits.abs().max()).item())
        toks.append(int(logits.argmax()))

    logits, cache = model.prefill(params, {"tokens": torch.as_tensor(prompt[None]).to(CARD)},
                                  cache)
    take(logits[0, -1, :v])
    for _ in range(max_new - 1):
        tok = torch.tensor([[toks[-1]]], device=CARD)
        logits, cache = model.decode_step(params, {"tokens": tok}, cache)
        take(logits[0, 0, :v])
    return toks, gaps


def serve_alone(serving, cfg, params, prompt, serve: dict, max_new: int) -> list:
    """One request served alone by an engine of the same ``serve`` config:
    the same slots, so every matmul has the serve's shape and placement."""
    eng = serving.ServeEngine(cfg, params, serving.ServeConfig(**serve), device=CARD)
    eng.submit(serving.Request(rid=0, prompt=prompt, max_new=max_new))
    return eng.run_until_drained()[0].out_tokens


def serve_lm(torch, kernels, record_routes, lm_mod, serving, cfg, params, prompts, *,
             serve: dict = LM_SERVE, max_new: int = LM_MAX_NEW, near_tie=None,
             alone: bool = False):
    """Serve the requests with every launch count at 0 just before and read
    just after; tokens must equal each request's single-request greedy run,
    and launches the prediction: 7 routed matmuls a layer plus the lm head a
    forward, every one on the AryPE at these shapes (``mm_fused``), one
    forward a prefill and one a decode step (every wave of ``max_new``-token
    requests takes ``max_new - 1`` steps), and one ``flash_fwd`` a layer a
    prefill.  With ``near_tie`` (a share of max|logit|) a request may leave
    its batch-1 tokens where that run's top two logits were closer than it
    (counted; the rest of that request is not compared): at batch 1 the
    plain PyTorch decode attention sums in another order than at the
    serve's slots (the matmuls agree bit for bit: the VPE's one-row
    projections run ``mm_fused``'s skinny kernel).  With ``alone`` the
    tokens must also equal, exactly, each request served alone by an engine
    of the same config (the same shapes and placements: no kernel's rows
    depend on the other slots).  Returns (launch counts, the engine's stats,
    the batch-1 runs' launch counts, near ties)."""
    refs_alone = [serve_alone(serving, cfg, params, p, serve, max_new) for p in prompts] \
        if alone else None
    kernels.reset_launches()
    refs = [greedy_single(torch, lm_mod.LM(cfg, device=CARD), params, p, max_new,
                          serve["cache_len"]) for p in prompts]
    single_counts = kernels.launches()
    eng = serving.ServeEngine(cfg, params, serving.ServeConfig(**serve), device=CARD)
    reqs = [serving.Request(rid=i, prompt=p, max_new=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    kernels.reset_launches()
    with record_routes() as routes:
        done = eng.run_until_drained()
    counts = kernels.launches()
    st = eng.stats
    if len(done) != len(reqs):
        raise AssertionError(f"{len(done)} of {len(reqs)} requests finished")
    if alone:
        for r, ref in zip(reqs, refs_alone):
            if r.out_tokens != ref:
                raise AssertionError(f"request {r.rid}: engine {r.out_tokens} != served alone "
                                     f"{ref}")
        log(f"  tokens equal, exactly, to each request served alone at "
            f"{serve['batch_slots']} slots")
    ties = 0
    for r, (ref, gaps) in zip(reqs, refs):
        if r.out_tokens == ref:
            continue
        t = next(i for i, (a, b) in enumerate(zip(r.out_tokens, ref)) if a != b)
        if near_tie is None or gaps[t] >= near_tie:
            raise AssertionError(f"request {r.rid}: engine {r.out_tokens} != single {ref} "
                                 f"(top-2 gap at token {t}: {gaps[t]:.3e} of max|logit|)")
        log(f"  request {r.rid}: token {t} differs at a near tie of the single run (top-2 "
            f"gap {gaps[t]:.3e} of max|logit| < {near_tie:.3e})")
        ties += 1
    waves = -(-len(reqs) // serve["batch_slots"])
    per_forward = 7 * cfg.num_layers + 1
    forwards = len(reqs) + waves * (max_new - 1)
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
        f"greedy run{f' except {ties} near ties' if near_tie is not None else ''}; "
        f"{st.prefills} prefills, {st.decode_steps} decode steps, {st.tokens} tokens")
    log(f"  prefill {st.prefill_s / st.prefills * 1e3:.3f} ms per admit ({serve['batch_slots']}-"
        f"slot batch, prompts {min(map(len, prompts))}-{max(map(len, prompts))}), decode "
        f"{st.decode_s / st.decode_steps * 1e3:.3f} ms per step, {st.tok_per_s:.1f} generated tok/s")
    log(f"  launches {counts} = predicted: {per_forward} mm_fused a forward x {forwards} "
        f"forwards, {cfg.num_layers} flash_fwd a prefill x {len(reqs)}")
    single = {name: n for name, n in single_counts.items() if n}
    log(f"  the {len(prompts)} single-request runs launched {single}")
    return counts, st, single_counts, ties


def profile_serve(torch, serving, cfg, params, prompts, label: str = "") -> None:
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
    log(f"[profile] serve{label} {len(prompts)} requests x 8 tokens: device busy {busy_us:.1f} us of "
        f"{wall_us:.1f} us traced wall, idle share {1 - busy_us / wall_us:.4f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total:11.1f} us  {e.count:6d} calls  {e.key[:90]}")


def lm_card_vs_cpu(torch, lm_mod, cfg, params, rng, tol: float = LM_LOGIT_TOL,
                   tie: float | None = None, control_cfg=None) -> None:
    """One request: prefill of a ``LM_CPU_PROMPT``-token prompt and
    ``LM_CPU_DECODES`` decode steps, every run fed the CPU's greedy tokens,
    at batch 1 on the card and on the CPU (plain twins).  The card's logits
    lie within ``tol`` of max|logit| of the CPU's, and its argmax equals the
    CPU's except where the CPU's top two logits are closer than ``tie``
    (``tol`` by default; counted).  With ``control_cfg`` (the f32-compute
    config of a bf16 ``cfg``) two more runs on the card: the request in each
    of ``LM_SERVE``'s slots (its decode projections on mm_fused, batch 1's
    on the VPE, the same bits; its plain decode attention not), held to the
    batch-1 card run as the card is to the CPU; and the control, the same
    weights and tokens in ``control_cfg``, whose distance from the CPU's
    bf16 logits is printed beside the others (see ``BF16_LOGIT_TOL``)."""
    tie = tol if tie is None else tie
    slots = LM_SERVE["batch_slots"]
    runs = {"card": (lm_mod.LM(cfg, device=CARD), params, 1),
            "cpu": (lm_mod.LM(cfg, device="cpu"), _tree_to(params, "cpu"), 1)}
    if control_cfg is not None:
        runs["slots"] = (lm_mod.LM(cfg, device=CARD), params, slots)
        runs["control"] = (lm_mod.LM(control_cfg, device=CARD), params, 1)
    caches = {name: m.init_cache(b, LM_SERVE["cache_len"]) for name, (m, _, b) in runs.items()}
    # (run, the run it is held to): the largest distance a step
    pairs = [("card", "cpu")] + ([("slots", "card"), ("control", "cpu")]
                                 if control_cfg is not None else [])
    worst, ties = dict.fromkeys(pairs, 0.0), 0
    tokens = rng.integers(0, cfg.vocab_size, (1, LM_CPU_PROMPT))
    for step in range(1 + LM_CPU_DECODES):
        call = "prefill" if step == 0 else "decode_step"
        out = {}
        for name, (m, p, b) in runs.items():
            batch = torch.as_tensor(tokens.repeat(b, axis=0)).to(m.device)
            logits, caches[name] = getattr(m, call)(p, {"tokens": batch}, caches[name])
            out[name] = logits[0, -1, :cfg.vocab_size].float().cpu()
        g = out["card"]
        if not (torch.isfinite(g).all() and g.shape == (cfg.vocab_size,)):
            raise AssertionError(f"{call} {step}: card logits not finite or of shape {g.shape}")
        dist = {}
        for a, b in pairs:
            scale = out[b].abs().max().item()
            dist[a, b] = (out[a] - out[b]).abs().max().item() / scale
            worst[a, b] = max(worst[a, b], dist[a, b])
        c = out["cpu"]
        scale = c.abs().max().item()
        top2 = c.topk(2).values
        gap = (top2[0] - top2[1]).item() / scale
        log(f"  {call} {step}: " + ", ".join(f"max|{a} - {b}| {d:.3e}" for (a, b), d in dist.items())
            + f" of max|logit| ({scale:.4f}); token card {int(g.argmax())} cpu {int(c.argmax())}"
            f", cpu top-2 gap {gap:.3e}")
        for a, b in pairs[:2]:
            if dist[a, b] > tol:
                raise AssertionError(f"{call} {step}: {a} logits differ from {b} by "
                                     f"{dist[a, b]:.3e} of max|logit|")
        for a, b in pairs[:2]:
            if int(out[a].argmax()) != int(out[b].argmax()):
                top2 = out[b].topk(2).values
                if (top2[0] - top2[1]).item() >= tie * out[b].abs().max().item():
                    raise AssertionError(f"{call} {step}: {a} token {int(out[a].argmax())} != "
                                         f"{b} {int(out[b].argmax())}")
                ties += 1
        tokens = c.argmax().reshape(1, 1).numpy()
    log("  worst " + ", ".join(f"{a} vs {b} {w:.3e}" for (a, b), w in worst.items())
        + f" of max|logit| (tolerance {tol:.3e}); tokens identical except {ties} near ties "
        f"(top-2 gap under {tie:.3e})")


def on_cpu(state):
    """A copy of a tracker state (hot-only or two-level) on the CPU."""
    return type(state)(*(on_cpu(x) if isinstance(x, tuple) else x.to("cpu", copy=True)
                         for x in state))


def same_tree(torch, label: str, a, b) -> None:
    """Raise unless two states or drain results are equal bit for bit."""
    for name, x, y in zip(a._fields, a, b):
        if isinstance(x, tuple):
            same_tree(torch, f"{label}.{name}", x, y)
        elif not torch.equal(x.cpu(), y.cpu()):
            raise AssertionError(f"{label}.{name} differs")


def same_run(torch, label: str, ref, pipe) -> None:
    """``pipe`` ended where the eager ``ref`` did: state, rules, counters."""
    same_tree(torch, f"{label} state", ref.state, pipe.state)
    if ref.rules.rules != pipe.rules.rules or ref.rules.generation != pipe.rules.generation:
        raise AssertionError(f"{label}: rule tables differ")
    for name in ("packets", "steps", "flows", "new_flows", "evicted", "spilled", "promoted",
                 "fallback_steps"):
        if getattr(ref.stats, name) != getattr(pipe.stats, name):
            raise AssertionError(f"{label}: stats.{name} {getattr(pipe.stats, name)}, eager "
                                 f"{getattr(ref.stats, name)}")


def run_mode(kernels, record_routes, prefetch, cs, pipe, batches, label: str, card: str):
    """Warm up, record one step's matmuls, then run the batches through
    ``prefetch`` with the launch counts set to 0 just before and read just
    after: they must equal what the recorded routes launch plus one
    ``flow_update`` a step.  Returns the stats."""
    pipe.warmup()
    with record_routes() as routes:
        out = pipe.step(batches[0])
        if pipe.cfg.overlap:
            out.wait()
    pipe.reset()
    kernels.reset_launches()
    stats = pipe.run(prefetch(iter(batches), depth=2), steps=len(batches))
    counts = kernels.launches()
    want = kernels.matmul_launches(routes, len(batches))
    want["flow_update"] += len(batches)
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts}, expected {want}")
    occupancy = int(cs.cold_occupancy(pipe.state.cold)) if pipe.cfg.cold_size else 0
    log(f"  {label}: step {stats.step_us:.1f} us (host {stats.host_s / stats.steps * 1e6:.1f} / "
        f"exposed device {stats.device_s / stats.steps * 1e6:.1f}), {stats.dispatches} "
        f"dispatches of {stats.dispatch_us:.1f} us, p99 {stats.p99_us:.1f} us, "
        f"{stats.pkt_per_s:.1f} pkt/s; flows {stats.flows}, evicted {stats.evicted}, spilled "
        f"{stats.spilled}, promoted {stats.promoted}, cold occupancy {occupancy}; launches "
        f"{ {k: v for k, v in counts.items() if v} } [{card}]")
    return stats


def host_waits(torch, cs, pipe, batches) -> dict:
    """The host's waits inside eager steps, from a CPU-side torch.profiler
    trace: reads of a device value (``aten::_local_scalar_dense``: the
    collision check, the cold store's record counts) and ``aten::nonzero``
    (a cold round's records), each call's time including its wait; and the
    cold store's rounds beyond the first of each walk (the ordered part)."""
    from torch.profiler import ProfilerActivity, profile

    walks = dict(walks=0, rounds=0)
    plain_rounds = cs._rounds

    def counting(touch, active):
        n = 0
        for sel in plain_rounds(touch, active):
            n += 1
            yield sel
        walks["walks"] += n > 0
        walks["rounds"] += n

    cs._rounds = counting
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for batch in batches:
                pipe.step(batch)
    finally:
        cs._rounds = plain_rounds
    res = dict(walks, reads=0, read_us=0.0, nonzero=0, nonzero_us=0.0)
    for e in prof.key_averages():
        if e.key == "aten::_local_scalar_dense":
            res["reads"], res["read_us"] = e.count, e.cpu_time_total
        elif e.key == "aten::nonzero":
            res["nonzero"], res["nonzero_us"] = e.count, e.cpu_time_total
    return {k: v / len(batches) for k, v in res.items()}


def track_parts(torch, cs, pipe, batches) -> dict:
    """Device-synchronised wall time (us a step) of each part of the tracker
    step: the merge, and with a cold table the promote walk, the spill walk
    and the scrub.  Each part is bracketed by ``torch.cuda.synchronize``, so
    the parts run serialised; their sum is not the overlapped step time."""
    spent = dict(merge=0.0, promote=0.0, spill=0.0, scrub=0.0)

    def timed(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            return out
        return run

    plain = {name: getattr(cs, name) for name in ("promote_pass", "apply_spills", "scrub_live")}
    cs.promote_pass = timed("promote", plain["promote_pass"])
    cs.apply_spills = timed("spill", plain["apply_spills"])
    cs.scrub_live = timed("scrub", plain["scrub_live"])
    pipe._merge = timed("merge", pipe._merge)
    try:
        for batch in batches:
            pipe.step(batch)
    finally:
        for name, fn in plain.items():
            setattr(cs, name, fn)
        del pipe._merge
    return {name: t / len(batches) * 1e6 for name, t in spent.items()}


def two_level_phase(torch, kernels, record_routes, cs, prefetch, TrafficConfig,
                    TrafficGenerator, OctopusPipeline, PipelineConfig, mlp, cnn, card) -> None:
    """The loop's dispatch modes and the two-level table at the 8k hot table
    and a 2^20-entry cold bank, on traffic with 8 live flows a hot slot."""
    batches = make_batches(TrafficConfig, TrafficGenerator, SPILL_TRAFFIC, TWO_LEVEL_STEPS, "cpu")
    log(f"[pipeline two-level] CNN f32, {PIPE}, cold_size {COLD_SIZE}, traffic {SPILL_TRAFFIC}, "
        f"{TWO_LEVEL_STEPS} steps through prefetch; each mode against scan_len 1, overlap off")
    modes = ((1, False), (CHUNK, False), (1, True), (CHUNK, True))
    for cold, policy, wanted in ((0, "age", modes), (COLD_SIZE, "age", modes),
                                 (COLD_SIZE, "lru", (modes[0], modes[3]))):
        eager = None
        for scan_len, overlap in wanted:
            cfg = PipelineConfig(**PIPE, cold_size=cold, cold_policy=policy, scan_len=scan_len,
                                 overlap=overlap)
            label = (f"{'two-level ' + policy if cold else 'hot-only'}, scan_len {scan_len}, "
                     f"overlap {'on' if overlap else 'off'}")
            pipe = OctopusPipeline(mlp, cnn, cfg)
            stats = run_mode(kernels, record_routes, prefetch, cs, pipe, batches, label, card)
            if cold and not (stats.spilled and stats.promoted):
                raise AssertionError(f"{label}: spilled {stats.spilled}, promoted "
                                     f"{stats.promoted}")
            if eager is None:
                eager = pipe
            else:
                same_run(torch, label, eager, pipe)
                del pipe
        del eager
        torch.cuda.empty_cache()
    # step by step: eager outputs against handles waited one behind, and the
    # first steps against the CPU at the full cold bank
    for policy in ("age", "lru"):
        cfg = dict(PIPE, cold_size=COLD_SIZE, cold_policy=policy)
        eager = OctopusPipeline(mlp, cnn, PipelineConfig(**cfg))
        drained = []
        for step, batch in enumerate(batches):
            drained.append(on_cpu(eager.step(batch).drained))
            if step + 1 == TWO_LEVEL_CPU_STEPS:
                snapshot = on_cpu(eager.state)
        ovl = OctopusPipeline(mlp, cnn, PipelineConfig(**cfg, scan_len=CHUNK, overlap=True))
        pending, outs = None, []
        for k in range(0, len(batches), CHUNK):
            handle = ovl.step_many(batches[k:k + CHUNK])
            if pending is not None:
                outs.append(pending.wait())
            pending = handle
        outs.append(pending.wait())
        for step in range(len(batches)):
            out = outs[step // CHUNK].drained
            same_tree(torch, f"{policy} step {step} drained (overlapped chunk)",
                      drained[step], type(out)(*(leaf[step % CHUNK] for leaf in out)))
        same_run(torch, f"{policy} handles", eager, ovl)
        del eager, ovl
        torch.cuda.empty_cache()
        cpu = OctopusPipeline(mlp, cnn, PipelineConfig(**cfg), device="cpu")
        for step, batch in enumerate(batches[:TWO_LEVEL_CPU_STEPS]):
            same_tree(torch, f"{policy} step {step} drained (card vs cpu)", drained[step],
                      cpu.step(batch).drained)
        same_tree(torch, f"{policy} state after {TWO_LEVEL_CPU_STEPS} steps (card vs cpu)",
                  snapshot, cpu.state)
        log(f"  {policy}: drained rows of {len(batches)} steps equal between eager steps and "
            f"scan_len {CHUNK} handles; hot and cold leaves, drained rows and counts equal the "
            f"CPU's over {TWO_LEVEL_CPU_STEPS} steps (spilled {cpu.stats.spilled}, promoted "
            f"{cpu.stats.promoted}, cold occupancy {int(cs.cold_occupancy(cpu.state.cold))})")
        del cpu, snapshot
    # the host's waits and the tracker's parts a step, and the cold store's
    # ordered part under attack
    attack = make_batches(TrafficConfig, TrafficGenerator, ATTACK, 24, "cpu")
    for label, cold, source in (("hot-only", 0, batches), ("two-level age", COLD_SIZE, batches),
                                ("hot-only, collision attack", 0, attack),
                                ("two-level age, collision attack", COLD_SIZE, attack)):
        pipe = OctopusPipeline(mlp, cnn, PipelineConfig(**PIPE, cold_size=cold))
        pipe.warmup()
        stats = pipe.run(source[:8], steps=8)
        log(f"  {label}, eager: steps 1-8 {stats.step_us:.1f} us (host {stats.host_us:.1f} / "
            f"exposed device {stats.device_us:.1f}), spilled {stats.spilled}, promoted "
            f"{stats.promoted} [{card}]")
        w = host_waits(torch, cs, pipe, source[8:16])
        log(f"    host waits a step (steps 9-16, profiled): {w['reads']:.1f} value reads "
            f"{w['read_us']:.1f} us, {w['nonzero']:.1f} nonzero {w['nonzero_us']:.1f} us; cold "
            f"walks {w['walks']:.2f}, their rounds {w['rounds']:.2f}")
        parts = track_parts(torch, cs, pipe, source[16:24])
        log("    tracker parts, us a step (steps 17-24, each synchronised): " + ", ".join(
            f"{name} {us:.1f}" for name, us in parts.items() if cold or name == "merge"))
        del pipe
        torch.cuda.empty_cache()


def masked_phase(torch, ff, fx, ft, TrafficConfig, TrafficGenerator, OctopusPipeline,
                 PipelineConfig, mlp, cnn, card) -> None:
    """Bucketed, keep-masked steps at 256 and 8192 packets, card against
    CPU; the 8192 bucket folds through ``flow_update``'s chunked variant."""
    log(f"[pipeline masked] CNN f32, {PIPE}; warm_bucket{BUCKETS}, step_masked on ragged keep "
        f"masks, card vs CPU")
    gpu = OctopusPipeline(mlp, cnn, PipelineConfig(**PIPE))
    cpu = OctopusPipeline(mlp, cnn, PipelineConfig(**PIPE), device="cpu")
    for bucket in BUCKETS:
        gpu.warm_bucket(bucket)
    gen = TrafficGenerator(TrafficConfig(**TRAFFIC), device="cpu")
    rng = torch.Generator().manual_seed(5)
    near = flipped = 0
    for step in range(MASKED_STEPS):
        bucket = BUCKETS[step % len(BUCKETS)]
        parts = [gen.next_batch() for _ in range(max(1, bucket // TRAFFIC["batch_size"]))]
        batch = ft.PacketBatch(*(torch.cat(leaves)[:bucket] for leaves in zip(*parts)))
        keep = torch.rand(bucket, generator=rng) < (0.5 + 0.4 * torch.rand(1, generator=rng))
        plan = ff.flow_plan(bucket, PIPE["table_size"])
        before = ff.FLOW_UPDATE.launches
        out_g = gpu.step_masked(batch, keep)
        launched = ff.FLOW_UPDATE.launches - before
        out_c = cpu.step_masked(batch, keep)
        if launched != 1:
            raise AssertionError(f"bucket {bucket}: {launched} flow_update launches")
        same_tree(torch, f"masked step {step} state", gpu.state, cpu.state)
        same_tree(torch, f"masked step {step} drained", out_g.drained, out_c.drained)
        logits = cpu.packet_engine.fn(cpu.packet_engine.params, fx.packet_meta_features(batch))
        tie = (logits[:, 1] - logits[:, 0]).abs() < NEAR_TIE
        differ = (out_g.pkt_actions.cpu() != out_c.pkt_actions) & keep
        if (differ & ~tie).any() or not torch.equal(out_g.flow_cls.cpu(), out_c.flow_cls):
            raise AssertionError(f"masked step {step}: decisions differ away from a near tie")
        near += int((tie & keep).sum())
        flipped += int(differ.sum())
        log(f"  bucket {bucket} ({plan.variant} flow_update, {plan.ctas} CTAs): "
            f"{int(keep.sum())} kept, state and drained rows equal the CPU's")
    if not flipped and gpu.rules.rules != cpu.rules.rules:
        raise AssertionError("masked: rule tables differ with identical decisions")
    if ff.flow_plan(BUCKETS[-1], PIPE["table_size"]).variant != "chunked":
        raise AssertionError("the largest bucket did not take flow_update's chunked variant")
    s = gpu.stats
    log(f"  {s.steps} masked steps: {s.packets} packets, {s.padded} padding rows, {s.flows} "
        f"flows; decisions identical except {flipped} of {near} near ties; step "
        f"{s.step_us:.1f} us (host {s.host_us:.1f} / exposed device {s.device_us:.1f}) [{card}]")


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
    from repro_torch.core import cold_store as cs
    from repro_torch.data.traffic import TrafficConfig, TrafficGenerator, prefetch
    from repro_torch.kernels import build
    from repro_torch.kernels.arype_matmul import ops as arype
    from repro_torch.kernels.flow_features import ops as ff
    from repro_torch.kernels.vpe_smallmm.ops import (
        vpe_matmul,
        vpe_matmul_q,
        vpe_mm,
        vpe_mm_q,
        vpe_q_plan,
    )
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
    fused_q_plan = lambda m, k, n: arype.mm_fused_q_plan(m, k, n, arype.sm_count(torch.device(0)))
    log("[kernels] each kernel against its plain version on the card")
    results = {
        "flow_update": check_flow_update(torch, ff, gen),
        "vpe_mm": check_matmuls(torch, vpe_matmul, vpe_mm, VPE_SHAPES, gen),
        "mm_fused": check_matmuls(torch, arype.arype_matmul, arype.mm_fused, ARYPE_SHAPES, gen,
                                  plan=arype.card_plan),
        "vpe_mm_q": check_quant_matmuls(torch, vpe_matmul_q, vpe_mm_q, VPE_SHAPES, gen,
                                        plan=vpe_q_plan),
        "mm_fused_q": check_quant_matmuls(torch, arype.arype_matmul_q, arype.mm_fused_q,
                                          ARYPE_SHAPES, gen, plan=fused_q_plan),
        "mm_unfused_partials": check_unfused(torch, arype, UNFUSED_SHAPES, gen, UNFUSED_BK),
        "mm_partials_sum": check_partials_sum(torch, arype, gen, UNFUSED_BK),
    }
    lm_cfg = get_config(LM_ARCH).replace(compute_dtype="float32")
    lm_rng = np.random.default_rng(0)
    prompts = lm_prompts(lm_cfg, lm_rng)
    mixed = {"mm_fused": check_lm_matmuls(torch, arype, gen, lm_cfg,
                                          max(len(p) for p in prompts)),
             "vpe_mm": check_vpe_mixed(torch, vpe_matmul, vpe_mm, arype.arype_matmul, gen,
                                       lm_cfg)}
    log("[flash] flash_fwd against its plain twin on the card")
    results["flash_fwd"], flash_bf16 = check_flash(torch, fa, gen, [len(p) for p in prompts],
                                                   lm_cfg)
    log("[kernels] mm_fused and mm_fused_q at the transformer flow engine's shapes")
    for name, engine, plain, check, kw in (
            ("mm_fused", arype.arype_matmul, arype.mm_fused, check_matmuls,
             dict(plan=arype.card_plan)),
            ("mm_fused_q", arype.arype_matmul_q, arype.mm_fused_q, check_quant_matmuls,
             dict(plan=fused_q_plan))):
        r = check(torch, engine, plain, TF_ARYPE_SHAPES, gen, **kw)
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], r["max_abs_err"])
        log(f"  {name} per transformer step (6 layers): kernel {r['ms']:.5f} ms, plain "
            f"{r['plain_ms']:.5f} ms, library {r['library_ms']} ms, bound {r['bound_ms']:.6f} ms")
        if "taken" in r:
            log(f"  {name} over the {len(r['taken'])} shapes cuBLASLt takes "
                f"({', '.join(r['taken'])}): kernel {r['taken_ms']:.5f} ms, torch._int_mm "
                f"{r['taken_library_ms']:.5f} ms")
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
    # every AryPE matmul here has M > 8: the unfused partials at bk = 32 are
    # the fused kernel's promoted 32-deep tile sums, added in its order
    ref = cnn_apply(cnn_g, x, config=variants["arype_only fused"])
    got = cnn_apply(cnn_g, x, config=variants["arype_only unfused"])
    if not torch.equal(got, ref):
        raise AssertionError(f"table 6: unfused logits differ from fused by "
                             f"{(got - ref).abs().max().item()}")
    log("  arype_only unfused logits equal the fused ones bit for bit")
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

    # -- 11. the dispatch modes and the two-level flow table
    two_level_phase(torch, kernels, record_routes, cs, prefetch, TrafficConfig,
                    TrafficGenerator, OctopusPipeline, PipelineConfig, mlp, cnn, card)

    # -- 12. masked buckets
    masked_phase(torch, ff, fx, ft, TrafficConfig, TrafficGenerator, OctopusPipeline,
                 PipelineConfig, mlp, cnn, card)

    # -- 13. LM serving: qwen3-0.6b at full width and depth
    t0 = time.perf_counter()
    lm_params = lm_mod.LM(lm_cfg, device=CARD).init(torch.Generator(device=CARD).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(lm_params))
    log(f"[lm] {LM_ARCH}, f32 compute, {n_params} port-initialised parameters (seed 0) in "
        f"{time.perf_counter() - t0:.2f} s; ServeConfig({LM_SERVE}), {LM_REQUESTS} requests, "
        f"prompts {sorted(len(p) for p in prompts)}, max_new {LM_MAX_NEW}")
    lm_counts, st32, _, _ = serve_lm(torch, kernels, record_routes, lm_mod, serving, lm_cfg,
                                     lm_params, prompts)
    counts["flash_fwd"] = lm_counts["flash_fwd"]
    if profile:
        profile_serve(torch, serving, lm_cfg, lm_params, prompts[:4], " f32")

    # -- 14. LM card vs CPU
    log(f"[lm card vs cpu] batch 1, a {LM_CPU_PROMPT}-token prompt, prefill + {LM_CPU_DECODES} "
        f"decode steps at full depth")
    lm_card_vs_cpu(torch, lm_mod, lm_cfg, lm_params, lm_rng)

    # -- 15. LM serving at the registered compute dtype: bf16 activations on
    # the same f32 weights, the config from get_config unmodified
    bf_cfg = get_config(LM_ARCH)
    log(f"[lm bf16] {LM_ARCH} as registered (compute {bf_cfg.compute_dtype}, params "
        f"{bf_cfg.param_dtype}), the same weights, requests and ServeConfig; near ties under "
        f"{BF16_TIE_GAP} of max|logit| counted")
    bf_counts, st16, singles, _ = serve_lm(torch, kernels, record_routes, lm_mod, serving, bf_cfg,
                                           lm_params, prompts, near_tie=BF16_TIE_GAP, alone=True)
    for label, a, b in (("prefill ms per admit", st32.prefill_s / st32.prefills,
                         st16.prefill_s / st16.prefills),
                        ("decode ms per step", st32.decode_s / st32.decode_steps,
                         st16.decode_s / st16.decode_steps)):
        log(f"  {label}: f32 {a * 1e3:.3f}, bf16 {b * 1e3:.3f} ({b / a:.3f}x)")
    log(f"  generated tok/s: f32 {st32.tok_per_s:.2f}, bf16 {st16.tok_per_s:.2f}")
    mixed["mm_fused"]["launches"] = bf_counts["mm_fused"]
    flash_bf16["launches"] = bf_counts["flash_fwd"]
    mixed["vpe_mm"]["launches"] = singles["vpe_mm"]
    if singles["vpe_mm"] == 0:
        raise AssertionError("the batch-1 runs placed no projection on the VPE")
    if profile:
        profile_serve(torch, serving, bf_cfg, lm_params, prompts[:4], " bf16")
    log(f"[lm bf16 card vs cpu] batch 1, a {LM_CPU_PROMPT}-token prompt, prefill + "
        f"{LM_CPU_DECODES} decode steps at full depth")
    lm_card_vs_cpu(torch, lm_mod, bf_cfg, lm_params, lm_rng, tol=BF16_LOGIT_TOL,
                   tie=BF16_TIE_GAP, control_cfg=lm_cfg)
    del lm_params
    torch.cuda.empty_cache()

    # -- 16. gemma3-1b at full width, as registered
    g_cfg = get_config(GEMMA_ARCH)
    t0 = time.perf_counter()
    g_params = lm_mod.LM(g_cfg, device=CARD).init(torch.Generator(device=CARD).manual_seed(0))
    torch.cuda.synchronize()
    g_rng = np.random.default_rng(2)
    g_prompts = [g_rng.integers(0, g_cfg.vocab_size, n) for n in GEMMA_PROMPTS]
    log(f"[lm gemma3-1b] {GEMMA_ARCH} as registered (compute {g_cfg.compute_dtype}: embed_scale "
        f"makes the stack f32), d_model {g_cfg.d_model}, head_dim {g_cfg.head_dim}, window "
        f"{g_cfg.window_size}, vocab {g_cfg.vocab_size}, {g_cfg.num_layers} layers, "
        f"{sum(t.numel() for t in _leaves(g_params))} parameters (seed 0) in "
        f"{time.perf_counter() - t0:.2f} s; ServeConfig({GEMMA_SERVE}), prompts "
        f"{list(GEMMA_PROMPTS)}, max_new {GEMMA_MAX_NEW}; near ties under {LM_LOGIT_TOL} counted")
    serve_lm(torch, kernels, record_routes, lm_mod, serving, g_cfg, g_params, g_prompts,
             serve=GEMMA_SERVE, max_new=GEMMA_MAX_NEW, near_tie=LM_LOGIT_TOL)
    del g_params
    torch.cuda.empty_cache()

    # -- 17. records
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
    # the mixed arms (bf16 x, f32 w) of mm_fused (the bf16 serve) and vpe_mm
    # (its batch-1 single-request runs), timed at the LM's shapes
    record += [dict(name=f"{name} (bf16 x, f32 w)", route="cuda", source=source[name],
                    replaces=replaces[name], **r) for name, r in mixed.items()]
    # flash_fwd's bf16 tensor-core kernel (the bf16 serve's prefill)
    record.append(dict(name="flash_fwd (bf16)", route="cuda", source=source["flash_fwd"],
                       replaces=replaces["flash_fwd"], **flash_bf16))
    log(card)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def kernel_times(argv) -> int:
    """``--kernel-times [--src DIR] [--label NAME]``: device times of the
    engine and flash kernels at the shapes the smoke checks, each beside one
    library call, and nothing else, to compare two source trees on one card
    in turns (a, b, b, a).  ``--src`` is the ``src`` directory whose
    ``repro_torch`` is timed (this checkout's by default), so an older tree
    unpacked beside this one is timed by the same code; only the wrappers
    every tree has are called.  Shapes: ARYPE_SHAPES and TF_ARYPE_SHAPES
    (``mm_fused``; ``mm_fused_q`` on dense and on post-ReLU inputs), the
    LM's decode and longest-prefill layer matmuls (``mm_fused``, and its
    mixed arm ``mm_fused_bf16x`` on bf16 x into bf16, beside
    ``torch.matmul(x.float(), w).to(torch.bfloat16)``, where the tree has it), and the
    unfused matmul at UNFUSED_SHAPES and Table 6's layers (bk 32) and at
    Table 6's (bk 128); the launch floor, ``flow_update`` and ``vpe_mm_q``
    (:func:`kernel_times_fold`); ``vpe_mm`` (:func:`kernel_times_vpe`) and
    ``flash_fwd`` (:func:`kernel_times_flash`) at the LM's shapes.  Prints
    one JSON object a line: ``{"label", "kernel", "name", "shape", "ms",
    "library_ms"}``, the library call ``torch.matmul`` (f32, and for the
    unfused matmul, which adds ``plain_ms``), ``torch._int_mm`` on operands
    quantized beforehand (int8, where cuBLASLt takes the shape) or
    ``scaled_dot_product_attention`` (flash); a sum over a forward or over
    the prefill shapes has ``shape`` null."""
    import argparse
    import inspect

    import numpy as np
    import torch

    ap = argparse.ArgumentParser(prog="chip_smoke.py --kernel-times")
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.core.collaborative import usecase2_layers
    from repro_torch.kernels.arype_matmul import ops as arype
    from repro_torch.runtime.quant import pick_scale, quantize_i8

    gen = torch.Generator(device="cuda").manual_seed(0)

    def emit(kernel, name, shape, ms, library_ms, **extra):
        print(json.dumps(dict(label=args.label, kernel=kernel, name=name, shape=shape, ms=ms,
                              library_ms=library_ms, **extra)), flush=True)

    cfg = get_config(LM_ARCH)
    slots = LM_SERVE["batch_slots"]
    longest = max(map(len, lm_prompts(cfg, np.random.default_rng(0))))
    lm = {}  # one of each (rows, K, N): wv is wk's, wi_up wi_gate's; no head
    for label, rows in (("decode", slots), (f"prefill{longest}", slots * longest)):
        for name, m, k, n in lm_matmul_shapes(cfg, rows)[:-1]:
            lm.setdefault((m, k, n), (f"{label}/{name}", m, k, n))
    table6 = usecase2_layers(TABLE6_FLOWS)
    for name, m, k, n in ARYPE_SHAPES + TF_ARYPE_SHAPES + list(lm.values()):
        x = torch.randn(m, k, generator=gen, device="cuda")
        w = torch.randn(k, n, generator=gen, device="cuda")
        emit("mm_fused", name, (m, k, n), time_ms(lambda: arype.arype_matmul(x, w)),
             time_ms(lambda: torch.matmul(x, w)))
    # the mixed arm (bf16 x, f32 w, bf16 out), in a tree that has it
    if "out_dtype" in inspect.signature(arype.arype_matmul).parameters:
        for name, m, k, n in lm.values():
            x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
            w = torch.randn(k, n, generator=gen, device="cuda")
            emit("mm_fused_bf16x", name, (m, k, n), time_ms(lambda: arype.arype_matmul(x, w)),
                 time_ms(lambda: torch.matmul(x.float(), w).to(torch.bfloat16)))
    for name, m, k, n in ARYPE_SHAPES + TF_ARYPE_SHAPES:
        w = torch.randn(k, n, generator=gen, device="cuda")
        sw = tuple(pick_scale(v) for v in w.abs().amax(0).tolist())
        # dense inputs, and post-ReLU ones (about half zeros) as the CNN's
        # fc and linear and the transformer's mlp2 get them
        for kind, x in (("dense", torch.randn(m, k, generator=gen, device="cuda") * 3),
                        ("relu", torch.randn(m, k, generator=gen, device="cuda").clamp_min(0))):
            sx = pick_scale(x.abs().max().item())
            lib = None
            if m > 16 and k % 8 == 0 and n % 8 == 0:  # as check_quant_matmuls
                xq, wq = quantize_i8(x, sx), quantize_i8(w, sw)
                lib = time_ms(lambda: torch._int_mm(xq, wq))
            emit("mm_fused_q", f"{name}/{kind}", (m, k, n),
                 time_ms(lambda: arype.arype_matmul_q(x, w, scale_x=sx, scale_w=sw)), lib)
    for bk, shapes in ((32, UNFUSED_SHAPES), (32, table6), (128, table6)):
        for name, m, k, n in shapes:
            x = torch.randn(m, k, generator=gen, device="cuda")
            w = torch.randn(k, n, generator=gen, device="cuda")
            emit("mm_unfused", f"{name}/bk{bk}", (m, k, n),
                 time_ms(lambda: arype.arype_matmul_unfused(x, w, bk=bk)),
                 time_ms(lambda: torch.matmul(x, w)),
                 plain_ms=time_ms(lambda: arype.mm_unfused(x, w, bk=bk)))
    kernel_times_fold(torch, gen, emit)
    gemma = get_config(GEMMA_ARCH)
    kernel_times_vpe(torch, gen, emit, cfg, gemma)
    kernel_times_flash(torch, gen, emit, cfg, gemma, longest)
    return 0


def kernel_times_fold(torch, gen, emit) -> None:
    """``launch_floor``: ``torch.cuda._sleep(0)``, a launch that does nothing.
    ``flow_update`` through ``flow_feature_update`` at the pipeline's P and F,
    slots spread over [0, F] and on 3 slots, with the port kernel launches a
    call; and, as ``flow_update part``, the stable ``torch.sort`` of the slots
    and the table's ``clone`` (what an older wrapper ran beside its kernel;
    the smoke's ``flow_update`` check times this tree's kernel alone).
    ``vpe_mm_q`` through ``vpe_matmul_q`` at each VPE_SHAPES entry, dense
    inputs and per-channel scales as ``check_quant_matmuls`` makes them, and
    their sum, one pipeline step (``torch._int_mm`` takes none of them)."""
    from repro_torch.kernels.flow_features import ops as ff
    from repro_torch.kernels.vpe_smallmm import ops as vpe
    from repro_torch.runtime.quant import pick_scale

    emit("launch_floor", "torch.cuda._sleep(0)", None, time_ms(lambda: torch.cuda._sleep(0)),
         None)
    F, P = PIPE["table_size"], PIPE["batch_size"]
    rand32 = lambda *shape: torch.randint(-2**31, 2**31, shape, generator=gen, device="cuda",
                                          dtype=torch.int64).to(torch.int32)
    program = ff.default_program("cuda")
    for name, hi in (("spread", F + 1), ("colliding", 3)):
        slots = torch.randint(0, hi, (P,), generator=gen, device="cuda").to(torch.int32)
        meta, table = rand32(P, 13), rand32(F, 16)
        before = ff.FLOW_UPDATE.launches
        ff.flow_feature_update(program, slots, meta, table)
        launches = ff.FLOW_UPDATE.launches - before
        emit("flow_update", name, (P, F),
             time_ms(lambda: ff.flow_feature_update(program, slots, meta, table)), None,
             launches=launches)
        emit("flow_update part", f"{name}/torch.sort(stable)", (P,),
             time_ms(lambda: torch.sort(slots, stable=True)), None)
    emit("flow_update part", "table.clone()", (F, 16), time_ms(table.clone), None)
    total = 0.0
    for name, m, k, n in VPE_SHAPES:
        x = torch.randn(m, k, generator=gen, device="cuda") * 3
        w = torch.randn(k, n, generator=gen, device="cuda")
        sx = pick_scale(x.abs().max().item())
        sw = tuple(pick_scale(v) for v in w.abs().amax(0).tolist())
        t = time_ms(lambda: vpe.vpe_matmul_q(x, w, scale_x=sx, scale_w=sw))
        emit("vpe_mm_q", name, (m, k, n), t, None)
        total += t
    emit("vpe_mm_q", f"pipeline step ({len(VPE_SHAPES)} shapes)", None, total, None)


def kernel_times_vpe(torch, gen, emit, cfg, g) -> None:
    """``vpe_mm`` in f32 and in the mixed arm (bf16 x into bf16) at the
    batch-1 decode projections of qwen3-0.6b and gemma3-1b (wq, wk = wv, wo)
    (``g``) and at the pipelines' shapes, beside ``torch.matmul`` (the mixed
    arm's: ``torch.matmul(x.float(), w).to(torch.bfloat16)``), the mixed arm
    where the tree has it; then both summed over a batch-1 qwen3-0.6b decode
    forward (4 calls a layer)."""
    import inspect

    from repro_torch.kernels.vpe_smallmm import ops as vpe

    mixed = "out_dtype" in inspect.signature(vpe.vpe_matmul).parameters
    shapes = [(f"{LM_ARCH}/batch1/{name}", 1, k, n)
              for name, k, n in (("wq", cfg.d_model, cfg.q_dim), ("wk", cfg.d_model, cfg.kv_dim),
                                 ("wo", cfg.q_dim, cfg.d_model))]
    shapes += [(f"{GEMMA_ARCH}/batch1/{name}", 1, k, n)
               for name, k, n in (("wq", g.d_model, g.q_dim), ("wk", g.d_model, g.kv_dim),
                                  ("wo", g.q_dim, g.d_model))]
    shapes += VPE_SHAPES
    per_layer = {"wq": 1, "wk": 2, "wo": 1}  # wv is wk's shape
    forward = {}
    for name, m, k, n in shapes:
        x = torch.randn(m, k, generator=gen, device="cuda")
        w = torch.randn(k, n, generator=gen, device="cuda")
        arms = [("vpe_mm", lambda: vpe.vpe_matmul(x, w), lambda: torch.matmul(x, w))]
        if mixed:
            xb = x.bfloat16()
            arms.append(("vpe_mm_bf16x", lambda: vpe.vpe_matmul(xb, w),
                         lambda: torch.matmul(xb.float(), w).to(torch.bfloat16)))
        for kernel, fn, lib in arms:
            t, tl = time_ms(fn), time_ms(lib)
            emit(kernel, name, (m, k, n), t, tl)
            if name.startswith(f"{LM_ARCH}/batch1/"):
                times = forward.setdefault(kernel, [0.0, 0.0])
                reps = cfg.num_layers * per_layer[name.rsplit("/", 1)[1]]
                times[0] += reps * t
                times[1] += reps * tl
    for kernel, (t, tl) in forward.items():
        emit(kernel, f"{LM_ARCH}/batch1 decode forward ({cfg.num_layers} x 4 calls)", None, t, tl)


def kernel_times_flash(torch, gen, emit, cfg, g, longest: int) -> None:
    """``flash_fwd`` in f32 and bf16 at the qwen3-0.6b prefill shapes the
    smoke serves (4 slots, 16 heads over 8, D 128, causal, the LM's strided
    (B, S, H, D) views) and summed over them, and at gemma3-1b's (``g``: 4
    slots, 4 heads over 1, D 256) for its prompts, local (window 512) and
    global (causal), beside ``scaled_dot_product_attention`` on the same
    views."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa

    slots = LM_SERVE["batch_slots"]
    lens = sorted(map(len, lm_prompts(cfg, np.random.default_rng(0))))
    cases = [(f"{LM_ARCH}/prefill{s}", cfg.num_heads, cfg.num_kv_heads, s, cfg.head_dim,
              "causal", 0) for s in lens]
    cases += [(f"{GEMMA_ARCH}/prefill{s}/{kind}", g.num_heads, g.num_kv_heads, s, g.head_dim,
               mask, g.window_size if mask == "local" else 0)
              for s in GEMMA_PROMPTS for kind, mask in (("local", "local"), ("global", "causal"))]
    for dtype in (torch.float32, torch.bfloat16):
        label = "flash_fwd" if dtype == torch.float32 else "flash_fwd_bf16"
        total = [0.0, 0.0]
        for name, hq, hkv, s, d, mask, window in cases:
            q, k, v = (torch.randn(slots, s, h, d, generator=gen, device="cuda").to(dtype)
                       .transpose(1, 2) for h in (hq, hkv, hkv))
            if mask == "causal":
                sdpa = dict(is_causal=True)
            else:
                pos = torch.arange(s, device="cuda")
                sdpa = dict(attn_mask=fa.valid_pairs(mask, window, s, pos[:, None], pos[None]))
            t = time_ms(lambda: fa.flash_attention(q, k, v, mask=mask, window=window))
            tl = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=hq != hkv,
                                                                **sdpa))
            emit(label, name, (slots, hq, hkv, s, d), t, tl)
            if name.startswith(f"{LM_ARCH}/"):
                total[0] += t
                total[1] += tl
        emit(label, f"{LM_ARCH}/prefill shapes summed ({len(lens)}, longest {longest})", None,
             *total)



if __name__ == "__main__":
    sys.exit(kernel_times(sys.argv[2:]) if sys.argv[1:2] == ["--kernel-times"] else main())
