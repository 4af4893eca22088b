#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # from the root of a checkout, on a machine with one card
    python3 chip_smoke.py --profile  # also trace 8 steps of the f32/int8 CNN and transformer
                                     # pipelines, of 1, 2 and 4 sharded lanes and a short LM
                                     # serve for the device-busy share
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
     65536 live flows (8 a hot slot), 32 steps through ``prefetch``, hot-only
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
     near ties; the 8192 bucket runs ``flow_update``'s chunked variant; then
     each engine kernel against its plain version at the shapes the
     buckets' recorded routes name, at phase 2's tolerances;
 13. ``[pipeline sharded]``: ``ShardedOctopusPipeline``, the lanes as one
     lane-batched bank: CNN f32 at the 8k table for 64 steps, the single
     lane's ``OctopusPipeline`` and then 1, 2 and 4 lanes, on the
     collision-free traffic (pkt/s, step us host / exposed
     device, launches a step: one ``flow_update`` a step whatever the lanes,
     the rest as ``record_routes`` predicts); 40 steps card vs CPU at each
     (the (S, F, ...) state, drained rows and counters bit for bit,
     decisions except near ties), and against the single lane where the
     reference's exactness preconditions hold (said where they do not);
     then, each card vs CPU, the collision attack pinned to lane 0 of 4 in
     rounds of 256 (4 ``flow_update`` a step), 4 two-level lanes of 2^18
     cold entries ("age") on the 65536-flow traffic, and int8 at 2 lanes;
     then each engine kernel (f32 and int8) against its plain version at
     every per-lane shape those runs' recorded routes name, at phase 2's
     tolerances;
 14. ``[service]``: ``OctopusService`` over the single lane and over 4 lanes,
     buckets (256, 1024, 4096), 8 closed-loop clients (``serve_stream``) of
     64-1500 packets a request, offload on and off, the clients' generators
     live and replayed (made before the run): no kernel-library build and no
     unwarmed bucket after ``start``, the queue back to 0, nothing shed;
     inline, every request's buckets and verdicts (except near ties) and the
     rule table equal the CPU port's on the same script; dispatches,
     coalesced, padded, pkt/s, wait and end-to-end p50/p99, host/step split;
     then the 4096-packet masked step alone on this thread and on a
     one-thread executor, in turns, and each engine kernel against its plain
     version at the shapes a masked step of each bucket runs it at, on both
     pipelines;
 15. ``[lm]``: LM serving, qwen3-0.6b at full width and depth in f32 compute
     with seeded port-initialised weights: ``ServeEngine`` (4 slots, 512
     cache rows) serves 8 requests of 16-300 prompt tokens and 16 new tokens;
     every request's tokens equal its single-request greedy run, and the
     launch counts equal the prediction (197 ``mm_fused`` a forward, 28
     ``flash_fwd`` a prefill); prefill ms, decode ms a step and tok/s;
 16. ``[lm card vs cpu]``: one 160-token request through ``LM.prefill`` and
     4 ``decode_step``s on the card and on the CPU, logits within
     ``LM_LOGIT_TOL`` of max|logit|, tokens identical except counted near ties;
 17. ``[lm bf16]``: qwen3-0.6b as registered (bf16 activations on the same
     f32 weights) serving the same requests: tokens equal, exactly, each
     request served alone at the same 4 slots, and its batch-1 greedy run
     except counted near ties under ``BF16_TIE_GAP`` (batch 1's plain decode
     attention sums in another order); launches as in 15, times beside the
     f32 run's; ``[lm bf16 card vs cpu]`` as 16 within ``BF16_LOGIT_TOL``,
     with the request in all 4 slots held to the batch-1 card run the same
     way, and the f32-compute control's distance printed beside them;
 18. ``[lm gemma3-1b]``: gemma3-1b at full width as registered (head_dim 256,
     the 512-token window, vocab 262144; its embed_scale makes the stack f32)
     serving 4 requests, one past the window: tokens equal the single-request
     runs except counted near ties under ``LM_LOGIT_TOL``, launches as
     predicted (183 ``mm_fused`` a forward, 26 ``flash_fwd`` a prefill);
 19. ``[extractor]``: ``FeatureExtractor`` over whole traces (4096 flows x
     20 packets on the 8k table: 81920 packets, 20 ``flow_update`` chunks;
     the reference bench's 400 x 20; 4096 colliding flows, the merge's scan
     fallback): ``extract_segmented``, ``extract_scan`` and ``extract_scan``
     with the fold replayed, bit for bit with each other and card vs CPU,
     one ``flow_update`` a folding mode; the replay's fold (dropped packets
     spread over the chunks) and the same packets in slot order against the
     plain fold; Mpkt/s of each mode beside the paper's FPGA figure;
 20. ``[paths]``: ``PacketPath`` at batches 1, 8, 1024 and 8192 (latency a
     call with the host / device-wait split, ns a packet) and ``FlowPath``
     (CNN at 1000 and 4096 flows, the transformer at 256; flow/s) on the
     extracted flows, decisions card vs CPU except counted near ties,
     launches as recorded; then each engine kernel against its plain version
     at every shape the paths ran it at;
 21. ``[scenarios]``: CNN f32 at the 8k table, card vs CPU: the heavy hitter
     on the 65536-flow colliding traffic with a 2^20 cold table, and on 4
     lanes of 2^18, top-k equal card, CPU and a host model of the byte
     counters every step, launching only ``flow_update``; DDoS on 4096
     elephants, the band from a probe's score quantiles, emissions card vs
     CPU (scores within ``DDOS_SCORE_RTOL``, denied sets except near ties),
     every denied flow reading deny after each dispatch; the flash crowd,
     elephant storm and collision attack, tracker state and counters card vs
     CPU; step us and launches of each;
 22. ``[calibrate]`` (after 10): ``autotune.calibrate`` on the card over the
     reference's 64-point (m, k, n) grid, twice: each shape's ``mm_fused``
     and ``vpe_mm`` times through ``router.matmul`` (forced ``arype_only``,
     ``vpe_only``), both fits' ``tau``/``vpe_max_elems``, and the M = 8
     shapes, where both arms launch the same skinny kernel, with the fit
     left without them; the artifact through ``RuntimeConfig.calibrated``
     and its ``divergence_report`` at 1000 flows; the CNN pipeline under the
     calibrated config (launches as the calibrated placements predict, every
     routed shape against its plain version, card vs CPU: tracker state,
     drained rows and decisions bit for bit, logits within rtol 1e-5 on the
     CPU's inputs); ``python -m repro_torch.launch.calibrate --smoke`` in a
     subprocess, exit 0;
 23. ``[lm granite-moe-1b-a400m]`` (after 18): granite at full width and
     depth as registered (bf16 compute, f32 weights, 32 experts of 512 top
     8) serving 4 requests: tokens equal each request served alone, and the
     batch-1 runs except counted near ties; launches as predicted (97
     ``mm_fused`` a forward, 24 ``flash_fwd`` a prefill); every routed
     matmul shape (mixed arm) and flash prefill shape against its plain
     version; one request in f32 compute card vs CPU within
     ``LM_LOGIT_TOL``, with the expert ids held to the CPU's on the same
     layer inputs and the near ties counted;
 24. ``[lm starcoder2-15b]`` (after 23): starcoder2-15b at full width and
     depth as registered (bf16 weights and compute, 31.9 GB; the peak of the
     seeded init logged) serving granite's 4 prompts: tokens equal each
     request served alone, and the batch-1 runs except counted near ties;
     launches as predicted (241 ``mm_fused`` a forward, 40 ``flash_fwd`` a
     prefill); ``mm_fused``'s bf16-weight arm at every recorded shape, bit
     for bit with the f32 arm on x.float(), w.float() and within one bf16
     step of the plain twin, timed per decode and per 1200-row prefill
     forward beside ``torch.matmul`` on the same bf16 operands and the
     bound; the cold decode forward on the served weights; ``flash_fwd`` in
     bf16 at the prefill shapes (48 heads over 4, D 128); card vs CPU at
     full width and 2 of 40 superblocks in f32 compute (the f32 x on bf16 w
     arm) within ``LM_LOGIT_TOL`` and in bf16 compute within
     ``BF16_LOGIT_TOL``, the f32-compute control printed; ``vpe_mm``'s
     bf16-weight arm at M 1-8 on the served weights (equal to
     ``arype_matmul``) and at the VPE shapes of reduced starcoder2's batch-1
     runs on the card; the int8 pair on bf16 x into bf16 at the pipelines'
     shapes, bit for bit with its plain twin;
 25. ``[lm qwen3-4b]``: qwen3-4b at full width and depth as registered (f32
     weights, bf16 compute, 17.6 GB), 2 requests of 8 tokens: tokens as
     served alone and the batch-1 runs except counted near ties; 253
     ``mm_fused`` a forward, 36 ``flash_fwd`` a prefill;
 26. ``[train qwen3-0.6b]`` (after 25): qwen3-0.6b as registered (f32
     weights, bf16 compute, AdamW) trained by ``Trainer.run`` at full width
     and depth, 6 steps of 8 x 128 tokens from the token pipeline, one
     checkpoint (9 GB, under ``_train_ckpt/``, deleted after): each step's
     loss, wall ms, host enqueue and device ms (CUDA events), tokens/s, peak
     memory, the save's seconds; launches as predicted from the code (619
     ``mm_fused`` a step: 197 forward, 28 silu recomputes, 197 dX, 197 dW;
     28 ``flash_fwd``), by (x, w, out) arm; the step's matmul bound at the
     kernels' instruction rates; each distinct backward product at the
     step's 1024 rows bit for bit against the kernel called directly and
     against its plain twin, timed beside ``torch.matmul`` and its bound,
     with the transposes' copies; one step card vs CPU at full width and 2
     of 28 superblocks (f32 compute: loss, every gradient leaf, and the
     update on the card's gradients within their limits; bf16 compute
     printed beside the f32-compute control); 4 steps straight against a
     crash at step 3 and a resume from step 2, bit for bit.  ``--profile``
     traces two steps (device busy, idle share, top kernels).  Then
     ``flash_fwd`` alone at the step's shape (bf16, B 8, S 128, 16 heads over
     8, D 128) beside its plain twin, SDPA and its bound;
 27. ``[lm xlstm-1.3b]`` and ``[lm zamba2-2.7b]`` (after 26): the recurrent
     archs at full width and depth as registered (f32 weights, bf16
     compute; xlstm 42 mLSTM + 6 sLSTM blocks, zamba2 45 mamba2 blocks and
     its shared attention + MLP block at 9 places, head_dim 80), seed 0,
     serving 4 prompts of 45-300 tokens (8 new) at 4 slots x 512: tokens equal each
     request served alone and its batch-1 run except counted near ties
     under ``BF16_TIE_GAP`` (xlstm's batch-1 runs in f32 compute, since its
     random-weight stack carries a bf16 rounding past the logits' scale:
     ``RECURRENT_BATCH1``); launches as counted from the code
     (``lm_forward_matmuls``: 97 and 154 ``mm_fused`` a forward, 9
     ``flash_fwd`` a zamba2 prefill); prefill ms an admit, decode ms a step,
     tok/s and the peak GB; ``mm_fused``'s mixed arm at every recorded shape
     (zamba2's in_proj N 10448 off every tile multiple) against its plain
     twin, timed beside ``torch.matmul``; zamba2's ``flash_fwd`` at D 80 (the
     128-wide tile) at the prefill shapes against its plain twin and SDPA on
     f32 inputs, and on views into NaN-padded rows (no column past D read or
     written); one request in f32 compute card vs CPU at full width and 1
     superblock within ``LM_LOGIT_TOL``, beside the CPU's own move under a
     one-ulp change of the embedding;
 28. ``[lm hubert-xlarge]`` and ``[lm llama-3.2-vision-90b]`` (after 27): the
     stub frontends.  hubert at full width and depth as registered (f32
     weights, bf16 compute, encoder-only, seeded f32 frames in): forward and
     loss at 4 x 500 and 2 x 333 frames, prefill at 4 x 500 and 1 x 500,
     launches counted from the code (289 ``mm_fused`` and 48 ``flash_fwd``
     a forward; the batch-1 prefill's head on ``vpe_mm``), forward ms,
     frames/s, peak GB, the prefills' last logits held to the forward's;
     the mixed arms at every recorded shape (the gelu epilogue too) and
     ``flash_fwd`` under the full mask at D 80 against their plain twins;
     the forward card vs CPU in f32 at 2 of 48 superblocks.  llama-vision
     at full width, 2 of its 20 superblocks (bf16 weights and compute, 21.3
     GB): 4 requests of 300 tokens, each with its own 1600 image
     embeddings, one prefill and 8 decode steps (71 and 67 ``mm_fused``, 10
     and 2 ``flash_fwd``: cross decode attends the cached image keys through
     the flash kernel), prefill ms, decode ms a step, tok/s, peak GB; every
     row equal to its request alone at batch 1 except counted near ties;
     the bf16-weight arm at every recorded shape (the cross k/v over 6400
     image rows) and ``flash_fwd`` at the self and cross shapes (Sq 300
     and 1 against 1600 keys) against their twins, timed beside
     ``torch.matmul``/SDPA; decode vs forward in f32; one self and the
     cross layer card vs CPU in f32 at full width.

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
# the 128-row flash block), 16 new tokens each, 4 slots of 512 cache rows
LM_ARCH = "qwen3-0.6b"
LM_SERVE = dict(batch_slots=4, cache_len=512)
LM_REQUESTS, LM_MAX_NEW, LM_PROMPT = 8, 16, (16, 300)
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
TWO_LEVEL_STEPS, TWO_LEVEL_CPU_STEPS, CHUNK = 32, 16, 4
# masked buckets: a small request batch, and one past flow_update's chunk
BUCKETS, MASKED_STEPS = (256, 8192), 6
# sharded lanes: one lane-batched bank of S lanes of the 8k table, 64 steps
# timed and 40 against the CPU (flows first drain after ~30); the attack pins
# every flow to lane 0 of 4, which a lane capacity of 256 splits into 4 rounds
# a step; the two-level run keeps a 2^18-entry cold lane a lane (16 steps)
SHARDS, SHARDED_STEPS, SHARDED_CPU_STEPS, LANE_SPILL_STEPS = (1, 2, 4), 64, 40, 16
LANE_ATTACK = dict(ATTACK, adv_shards=4)
ATTACK_LANE_BATCH, LANE_COLD = 256, 1 << 18
# the async frontend: 8 closed-loop clients of ragged request sizes, 6 requests
# each, over the bucket sizes of a small, a step-sized and a large batch
SERVICE_BUCKETS = (256, 1024, 4096)
SERVICE_SIZES, SERVICE_REQUESTS = (64, 150, 300, 512, 700, 1000, 1200, 1500), 6
# the offline extractor: the paper's 8k table under 4096 flows of 20 packets
# (81920 packets, 20 of flow_update's 4096-packet chunks), the reference
# bench's 400 x 20 trace, and 4096 flows whose hashes collide (the merge's
# scan fallback); wall-clock ms of a mode: the median of EXTRACT_REPS calls
EXTRACT_TRACES = {
    "8k table": dict(num_flows=4096, pkts_per_flow=20, table_size=8192, seed=0),
    "bench 400x20": dict(num_flows=400, pkts_per_flow=20, table_size=8192, seed=0),
    "colliding": dict(num_flows=4096, pkts_per_flow=20, table_size=8192, seed=0,
                      collision_free=False)}
EXTRACT_REPS = 5
# the paper's figures for its FPGA (not this card): feature extraction,
# packet-based latency, flow-based throughput with collaborating
PAPER_MPKT_S, PAPER_PKT_NS, PAPER_KFLOW_S = 31, 207, 90
# the packet path: batch -> timed calls; the flow path: (model, flows), calls each
PATH_BATCHES = {1: 200, 8: 200, 1024: 50, 8192: 20}
FLOW_PATHS, FLOW_CALLS = (("cnn", 1000), ("cnn", 4096), ("transformer", 256)), 10
# the scenarios at PIPE: the heavy hitter on SPILL_TRAFFIC (card, CPU and the
# host's counters every step); DDoS on 4096 elephants, whose flows first
# drain after some 40 steps (a quarter packet a flow a step); the attacks
HH_K, HH_STEPS = 16, 16
DDOS_TRAFFIC = dict(batch_size=1024, active_flows=4096, table_size=8192, elephant_fraction=1.0,
                    elephant_pkts=(30, 60), seed=7)
DDOS_STEPS = 64
# anomaly scores (softmax probabilities) card against CPU, relative: the f32
# logits differ in the last bits (and log1p's input on about half the rows);
# logits apart by under NEAR_TIE move a probability by under twice that share
# (a reading on an H100 was 1.1e-5)
DDOS_SCORE_RTOL = 2 * NEAR_TIE
ADV_MODES = {"flash_crowd": dict(active_flows=4096, adv_period=4),
             "elephant_storm": dict(active_flows=4096, burst_len=8),
             "collision_attack": dict(active_flows=256, adv_slots=64)}
ADV_STEPS = 16
# the measured crossover: the reference's 64-point (m, k, n) grid swept twice
# on the card (the median of 5 synchronised calls a shape and arm; two sweeps
# show the fit's spread), the divergence report at Table 6's 1000 flows, then
# the CNN pipeline under the first sweep's artifact for the pipeline phase's
# 64 steps and card vs CPU for 64 (flows first drain after ~30); the CLI's
# smoke run in a subprocess
CALIB_ITERS, CALIB_SWEEPS, CALIB_CPU_STEPS, CALIB_CLI_TIMEOUT = 5, 2, 64, 600
# granite-moe-1b-a400m at full width and depth as registered (bf16 compute on
# f32 weights, 5.5 GB), 4 slots of 512 cache rows, 4 requests of 8 new
# tokens (one prompt of 300 tokens, past two 128-row flash blocks)
GRANITE_ARCH = "granite-moe-1b-a400m"
GRANITE_SERVE = dict(batch_slots=4, cache_len=512)
GRANITE_PROMPTS, GRANITE_MAX_NEW = (300, 45, 160, 97), 8
# starcoder2-15b at full width and depth as registered (bf16 weights and
# compute, 31.9 GB), granite's slots and prompts; its card-vs-CPU request at
# full width with the depth cut to STAR_CPU_SUPERBLOCKS (the host's memory and
# CPU time do not take 40 superblocks of plain PyTorch)
STAR_ARCH = "starcoder2-15b"
STAR_SERVE = dict(batch_slots=4, cache_len=512)
STAR_PROMPTS, STAR_MAX_NEW, STAR_CPU_SUPERBLOCKS = (300, 45, 160, 97), 8, 2
# vpe_mm's bf16-weight arm is timed on starcoder2's served weights at these M
VPE_SERVED_TIMED = (1, 2, 4, 8)
# qwen3-4b as registered (f32 weights, bf16 compute, 17.6 GB) at LM_SERVE's
# slots: 2 requests of 8 new tokens; its card-vs-CPU request at full width
# with the depth cut to QWEN4_CPU_SUPERBLOCKS, as starcoder2's
QWEN4_ARCH = "qwen3-4b"
QWEN4_PROMPTS, QWEN4_MAX_NEW, QWEN4_CPU_SUPERBLOCKS = (200, 37), 8, 4
# the recurrent archs at full width and depth as registered (f32 weights,
# bf16 compute): xlstm-1.3b (42 mLSTM + 6 sLSTM blocks, 7.1 GB) and
# zamba2-2.7b (45 mamba2 blocks and the shared attention + MLP block at 9
# places, head_dim 80, 8.3 GB), 4 slots of 512 cache rows, granite's prompts
# of 45-300 tokens; card vs CPU in f32 compute at RECURRENT_CPU_SUPERBLOCKS of
# their superblocks, at full width
RECURRENT_ARCHS = ("xlstm-1.3b", "zamba2-2.7b")
RECURRENT_SERVE = dict(batch_slots=4, cache_len=512)
RECURRENT_PROMPTS, RECURRENT_MAX_NEW, RECURRENT_CPU_SUPERBLOCKS = (300, 45, 160, 97), 8, 1
# The compute type in which each arch's serve is held to its batch-1 greedy
# runs.  xlstm's random-weight mLSTM stack amplifies a difference at a layer's
# input some 1.18-fold a layer: the first mLSTM's plain products (cuBLAS at
# another batch size) part batch 1 from the 4-slot row by 7.6e-06 of max|h| in
# f32 and by one bf16 step in bf16, and 48 layers carry that to 2.884e-03 of
# max|logit| in f32 and past the logits' own scale in bf16 (on an H100 80GB
# HBM3 at 700 W).  So its bf16 serve is held to each request served alone at
# the same slots, exactly, and the batch-1 check runs in f32 compute, a token
# differing only where the batch-1 run's top two logits are closer than
# RECURRENT_F32_TIE_GAP (over three times that reading)
RECURRENT_BATCH1 = {"xlstm-1.3b": "float32", "zamba2-2.7b": "bfloat16"}
RECURRENT_F32_TIE_GAP = 1e-2
# hubert-xlarge at full width and depth as registered (f32 weights, bf16
# compute, 3.78 GB; f32 normal frames in): forward and loss at 4 x 500 frames
# (10 s of audio at its 50 frames/s) and 2 x 333 (a ragged flash tile),
# prefill at 4 x 500 and 1 x 500; its prefill held to the forward by the
# reference's tests/test_consistency.py rule (2e-3 of max|logit|), card vs
# CPU in f32 compute at HUBERT_CPU_SUPERBLOCKS of its 48 superblocks
HUBERT_ARCH = "hubert-xlarge"
HUBERT_BATCHES, HUBERT_PREFILLS = ((4, 500), (2, 333)), ((4, 500), (1, 500))
HUBERT_PREFILL_TOL, HUBERT_CPU_SUPERBLOCKS = 2e-3, 2
# llama-3.2-vision-90b at full width, VISION_SUPERBLOCKS of its 20 (8 self and
# 2 cross layers, 10.66 B parameters, 21.3 GB of bf16: the whole model's 175
# GB does not fit one card), otherwise as registered; 4 requests of 300-token
# prompts, each with its own 1600 image embeddings (one length: LM.prefill
# takes one a batch, and the engine cannot feed images), 8 decode steps at
# 512 cache rows; decode vs forward in f32 compute after a prefill of
# VISION_DECODE_CHECK[0] tokens; card vs CPU on one self and the cross layer
# at full width over VISION_CPU_TOKENS tokens (the whole model's embedding
# and head alone are 8.4 GB of f32 on the host)
VISION_ARCH = "llama-3.2-vision-90b"
VISION_SUPERBLOCKS, VISION_REQUESTS, VISION_PROMPT, VISION_MAX_NEW = 2, 4, 300, 8
VISION_CACHE, VISION_DECODE_CHECK, VISION_CPU_TOKENS = 512, (297, 3), 160
# Decode against the forward in f32 compute, as shares of max|logit|.  With
# an f32 KV cache (the control) the two differ only in the order of f32 sums
# (the skinny kernel at one row against the tf32x3 tiles, the flash kernel
# against the plain decode attention, over 10 layers; one layer card vs CPU
# read 1.1e-06 to 1.9e-06 of its max): under DECODE_F32_TOL.  Served as the
# reference serves it, decode attends a bf16 KV cache where the forward
# attends f32 keys and values, so its logits carry the roundings of every
# cached key and value; they are held to BF16_LOGIT_TOL, the limit for
# logits that differ by bf16 roundings.  On an H100 80GB HBM3 at 700 W the
# 2-of-20-superblock llama-vision read 3.771e-03 with the bf16 cache and
# 3.151e-06 with an f32 one; on the CPU the reduced model reads 6.6e-03 and
# 1.7e-06 (max|logit| 0.51 there, 8.66 at full width, so the reference's
# absolute 2e-2 of tests/test_consistency.py does not carry over)
DECODE_F32_TOL = 1e-4
# [train qwen3-0.6b]: qwen3-0.6b as registered (f32 weights, bf16 compute,
# AdamW) trained at full width and depth by Trainer.run for TRAIN_STEPS steps
# of TRAIN_BATCH x TRAIN_SEQ tokens, saving once at the last step; then card
# against CPU and the resume, each at full width with the depth cut to
# TRAIN_CPU_SUPERBLOCKS and batch TRAIN_CPU_BATCH x TRAIN_SEQ.  Checkpoints
# go under TRAIN_CKPT (inside the checkout) and are deleted after the checks.
TRAIN_ARCH = "qwen3-0.6b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 6, 8, 128
TRAIN_CPU_SUPERBLOCKS, TRAIN_CPU_BATCH, TRAIN_RESUME_STEPS = 2, 2, 4
TRAIN_CKPT = ROOT / "_train_ckpt"
# card against CPU in f32 compute, one train step from the same params: the
# loss within rtol TRAIN_LOSS_RTOL, each gradient leaf within TRAIN_SHARE of
# its max|grad|, the updated parameters and moments within TRAIN_SHARE of
# their leaf's max|value| (the f32 sums of 1024-2048-deep products and of
# the 151936-deep head dX differ in order between the devices)
TRAIN_LOSS_RTOL, TRAIN_SHARE = 1e-5, 1e-4
# in bf16 compute, the gradients' relative L2 over all leaves, card against
# CPU: a bf16 rounding that a one-ulp difference of an f32 sum flips spreads
# through the layers, so the devices part by about what a change of the f32
# sums' order alone does on the CPU, two thirds of what bf16 compute itself
# moves the gradients from f32 compute (the control).  On an H100 80GB HBM3
# at 700 W: card vs CPU 1.021e-2, the order alone 9.644e-3, the control
# 1.505e-2; the limit lies between
TRAIN_BF16_L2 = 1.25e-2
# Expert routing, card against CPU on the same layer inputs.  The router
# logits are 1024-term f32 dot products that each device sums in another
# order (differences near 1e-6); a top-k pick may differ only where the
# CPU's logits at the swapped positions are closer than this (counted).
MOE_TIE_GAP = 1e-4


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


def note_shapes(kernels, routes, label: str, shapes: dict) -> None:
    """Each recorded matmul's (m, k, n) under the kernel it launches, named
    by the first run and layer that recorded it."""
    for r in routes:
        kernel = next(name for name, n in kernels.matmul_launches([r]).items() if n)
        shapes.setdefault(kernel, {}).setdefault((r.m, r.k, r.n), f"{label} {r.name}")


def check_recorded(checks: dict, shapes: dict, phase: str) -> dict:
    """Each engine kernel against its plain version on the card at every
    shape a phase's recorded routes name (``note_shapes``), through
    ``checks[kernel]`` (``check_matmuls``/``check_quant_matmuls`` at phase
    2's tolerances; they raise on a mismatch).  Returns each kernel's
    largest error."""
    errs = {}
    for kernel, seen in sorted(shapes.items()):
        log(f"  {kernel} at the {len(seen)} shapes {phase} launched it at, against its plain "
            "version:")
        errs[kernel] = checks[kernel]([(name, m, k, n) for (m, k, n), name in seen.items()]
                                      )["max_abs_err"]
    return errs


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
                 logit_tol: float | None = None, logit_rtol: float | None = None) -> dict:
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
    near a tie when the CPU's top two logits are that close.  With
    ``logit_rtol`` (the calibrated CNN) both devices' engines get the CPU's
    packet features and flow-model input for every row of the step (the
    pipeline's shapes, so its placements), and the card's packet and flow
    logits must lie within that rtol (atol ``logit_rtol * max|logit|``) of
    the CPU's; ``max_rel`` is their largest difference as a share of
    max|logit|.  Any other difference fails."""
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
        if logit_rtol is not None:
            for what, want, engine, x in (
                    ("packet", pkt_logits, gpu.packet_engine, fx.packet_meta_features(batch)),
                    ("flow", flow_logits, gpu.flow_engine, flow_x)):
                got = engine.fn(engine.params, x.cuda()).cpu()
                top = want.abs().max().item()
                if not torch.allclose(got, want, rtol=logit_rtol, atol=logit_rtol * top):
                    raise AssertionError(f"{label} step {step}: {what} logits differ by "
                                         f"{(got - want).abs().max().item()} on the CPU's input")
                res["max_rel"] = max(res["max_rel"],
                                     (got - want).abs().max().item() / (top or 1.0))
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


# the mixers whose layers run attention (a prefill: one flash_fwd each; a
# decode step: one for each cross-attention layer, the others attending their
# KV cache in plain PyTorch)
ATTN_MIXERS = ("attn", "attn_local", "attn_shared", "attn_cross")


def layer_matmuls(cfg, i: int, layer, decode: bool = False) -> list:
    """(name, k, n) of the routed matmuls of ``layer``, the ``i``-th of the
    model, counted from the model code: an attention mixer's four
    projections (a shared one's too; a cross one's at a decode step only q
    and o: its keys and values were cached at prefill), mamba2's in_proj and
    out_proj, the mLSTM's w_up and w_down, the sLSTM's w_gates and w_down; a
    dense or shared MLP's three (two when not gated), an MoE's shared
    experts' three (its experts are plain products), nothing for no FFN."""
    d, m, out = cfg.d_model, layer.mixer, []
    if m == "attn_cross" and decode:
        out += [("wq", d, cfg.q_dim), ("wo", cfg.q_dim, d)]
    elif m in ATTN_MIXERS:
        out += [("wq", d, cfg.q_dim), ("wk", d, cfg.kv_dim), ("wv", d, cfg.kv_dim),
                ("wo", cfg.q_dim, d)]
    elif m == "mamba2":
        din = cfg.ssm_d_inner
        out += [("in_proj", d, 2 * din + 2 * cfg.ssm_state + cfg.ssm_heads), ("out_proj", din, d)]
    elif m == "mlstm":
        out += [("w_up", d, 2 * cfg.mlstm_d_inner), ("w_down", cfg.mlstm_d_inner, d)]
    elif m == "slstm":
        out += [("w_gates", d, 4 * d), ("w_down", d, d)]
    if layer.ffn in ("mlp", "mlp_shared"):
        f = cfg.first_dense_ff if i < len(cfg.head_pattern) and cfg.first_dense_ff else cfg.d_ff
        out += [("wi_gate", d, f)] * cfg.mlp_gated + [("wi_up", d, f), ("wo_mlp", f, d)]
    elif layer.ffn == "moe" and cfg.num_shared_experts:
        f = cfg.moe_d_ff * cfg.num_shared_experts
        out += [("sh_gate", d, f), ("sh_up", d, f), ("sh_down", f, d)]
    return out


def lm_forward_matmuls(cfg, decode: bool = False) -> list:
    """(name, k, n) of every routed matmul of one LM forward (a prefill, or
    with ``decode`` a decode step): each layer's (``layer_matmuls``), then
    the lm head."""
    return ([mm for i, layer in enumerate(cfg.all_layers())
             for mm in layer_matmuls(cfg, i, layer, decode)]
            + [("lm_head", cfg.d_model, cfg.padded_vocab)])


def lm_matmul_shapes(cfg, rows: int) -> list:
    """(name, m, k, n) of the first block layer's routed matmuls
    (``layer_matmuls``) over ``rows`` token rows, then the lm head on the
    last positions of ``LM_SERVE``'s slots."""
    i = len(cfg.head_pattern)
    return ([(name, rows, k, n) for name, k, n in layer_matmuls(cfg, i, cfg.block_pattern[0])]
            + [("lm_head", LM_SERVE["batch_slots"], cfg.d_model, cfg.padded_vocab)])


def attention_layers(cfg) -> int:
    return sum(layer.mixer in ATTN_MIXERS for layer in cfg.all_layers())


def bf16_step(torch, v):
    """One bf16 step (ulp) at each |v|: 2^(e - 7) for |v| in [2^e, 2^(e+1))."""
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(2.0**-126))) - 7)


def product_record() -> dict:
    """Sums over a kernel's shapes, as the ``kernels`` line takes them."""
    return dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, ops_ms=0.0,
                bytes=0, flops=0)


def set_bound_by(rec: dict) -> dict:
    rec["bound_by"] = "bytes" if rec["bytes"] / HBM_BYTES_PER_S * 1e3 >= rec["ops_ms"] \
        else "operations"
    return rec


def hold_to_plain(torch, label: str, out, ref, rec: dict) -> float:
    """``out`` within one bf16 step of the plain twin's ``ref`` (f32 out: rtol
    1e-5), plus 1e-5 of max|ref|; the record keeps the largest error."""
    ref = ref.float()
    diff = (out.float() - ref).abs()
    lim = (bf16_step(torch, ref) if out.dtype == torch.bfloat16 else MATMUL_RTOL * ref.abs()) \
        + MATMUL_RTOL * ref.abs().max()
    if not (diff <= lim).all():
        raise AssertionError(f"{label}: max err {diff.max().item()} from the plain twin")
    err = diff.max().item()
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    return err


def time_product(torch, engine, plain, a, b, od, rec: dict, label: str, plan=None, *,
                 plain_calls: int = 5, plain_reps: int = 5) -> None:
    """Times of ``engine(a, b)`` into ``od``, its plain twin and the library
    call for the same function, ``torch.matmul`` on the same operands (on
    ``a.float()`` where the types differ) ``.to(od)``, added to ``rec`` with
    the bound: the operands' and the output's bytes over 3.35 TB/s, or the
    operations: a bf16 x bf16 product 2MKN over the dense bf16 rate (989
    TFLOP/s), whatever instruction the kernel issues; on the tf32x3 variant
    (``plan``) one tf32 ``mma.sync`` a step plus one for each f32 operand
    (a bf16 operand has no lo part), k x 2MKN over 495 TFLOP/s; else 2MKN
    f32 FMAs."""
    bf16, f32 = torch.bfloat16, torch.float32
    m, k, n = a.shape[0], a.shape[1], b.shape[1]
    t = time_ms(lambda: engine(a, b, out_dtype=od))
    tp = time_ms(lambda: plain(a, b, out_dtype=od), calls=plain_calls, reps=plain_reps)
    al = a.float() if a.dtype != b.dtype else a
    tl = time_ms(lambda: torch.matmul(al, b).to(od))
    out_size = torch.empty((), dtype=od).element_size()
    nbytes = a.element_size() * m * k + b.element_size() * k * n + out_size * m * n
    ops, rate, how = 2 * m * k * n, F32_OPS_PER_S, ""
    if plan is not None:
        p = plan(a.device, m, k, n)
        how = f" [{p.variant} {p.bm}x{p.bn} C={p.split}]"
        if p.variant == "tf32x3":
            ops, rate = (1 + (a.dtype == f32) + (b.dtype == f32)) * ops, TF32_OPS_PER_S
    if a.dtype == b.dtype == bf16:
        ops, rate = 2 * m * k * n, BF16_OPS_PER_S
    bnd, by = bound(nbytes, ops, rate)
    lib = "torch.matmul" if a.dtype == b.dtype else "torch.matmul(x.float(), w).to()"
    log(f"  {label} ({m},{k},{n}) -> {str(od)[6:]}{how}: kernel {t:.5f} ms, plain {tp:.5f} ms, "
        f"{lib} {tl:.5f} ms, bound {bnd:.6f} ms ({by})")
    for key, v in (("ms", t), ("plain_ms", tp), ("library_ms", tl), ("bound_ms", bnd),
                   ("ops_ms", ops / rate * 1e3), ("bytes", nbytes), ("flops", ops)):
        rec[key] += v


def check_mixed_matmuls(torch, engine, plain, shapes, gen, plan=None, *, w_dtype=None,
                        time_it: bool = True, same_as=None) -> dict:
    """An engine's bf16-x arm at each (name, m, k, n): bf16 x on w of
    ``w_dtype`` (f32 by default: the mixed arm; bf16: the bf16-weight arm),
    bf16 out, f32 for the ``lm_head`` (all four activations at the first
    shape), operands drawn from ``gen`` on its device.  The kernel must
    equal itself on ``x.float()``, ``w.float()`` rounded once, bit for bit,
    lie within one bf16 step (f32 out: rtol 1e-5) of the plain twin
    (:func:`hold_to_plain`), and, with ``same_as`` (``arype_matmul`` for the
    VPE), equal that engine at M <= 8, where both run the skinny split-K.
    With ``time_it``: :func:`time_product` at each shape, summed."""
    w_dtype = w_dtype or torch.float32
    bf16 = torch.bfloat16
    rec = product_record()
    label = f"{engine.__name__} bf16 x{', bf16 w' if w_dtype == bf16 else ''}"
    for i, (name, m, k, n) in enumerate(shapes):
        x = torch.randn(m, k, generator=gen, device=gen.device).to(CARD, bf16)
        w = torch.randn(k, n, generator=gen, device=gen.device).to(CARD, w_dtype)
        od = torch.float32 if name == "lm_head" else bf16
        for act in (ACTS if i == 0 else ("none",)):
            out = engine(x, w, activation=act, out_dtype=od)
            if not torch.equal(out, engine(x.float(), w.float(), activation=act).to(od)):
                raise AssertionError(f"{label} {name} ({m},{k},{n}) {act}: differs from the f32 "
                                     f"arm on x.float(), w.float()")
            if same_as is not None and m <= 8 and not torch.equal(
                    out, same_as(x, w, activation=act, out_dtype=od)):
                raise AssertionError(f"{label} {name} ({m},{k},{n}) {act}: differs from "
                                     f"{same_as.__name__}")
            hold_to_plain(torch, f"{label} {name} ({m},{k},{n}) {act}", out,
                          plain(x, w, activation=act, out_dtype=od), rec)
        if time_it:
            time_product(torch, engine, plain, x, w, od, rec, f"{label} {name}", plan)
    return set_bound_by(rec)


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
    time_cold_forward(torch, arype, calls, f"{dtype} x", cfg.num_layers)
    del calls, xs
    torch.cuda.empty_cache()


def time_cold_forward(torch, arype, calls, label: str, layers: int) -> dict:
    """A decode forward's matmuls ``calls`` ((x, w, out dtype) in forward
    order over ``layers`` distinct layers' weights, far past the 50 MB L2),
    one call each, behind the sleep kernel, median of 5; the kernel and the
    library call (``torch.matmul``, on x.float() for a bf16 x on f32 w; its
    output ``.to(out)``) the same way, beside the bound of reading every
    operand once and writing every output once.  Returns the kernel's and
    the library's ms and the bound."""
    nbytes = sum(x.element_size() * x.numel() + w.element_size() * w.numel()
                 + torch.empty((), dtype=od).element_size() * x.shape[0] * w.shape[1]
                 for x, w, od in calls)

    def forward(mm):
        for x, w, od in calls:
            mm(x, w, od)

    def library(x, w, od):
        if x.dtype == w.dtype:
            return torch.matmul(x, w).to(od)
        return torch.matmul(x.float(), w).to(od)

    # a few hundred enqueues take a few ms of host time: the sleep must outlast them
    t = time_ms(lambda: forward(lambda x, w, od: arype.arype_matmul(x, w, out_dtype=od)),
                calls=1, sleep_cycles=200_000_000)
    tl = time_ms(lambda: forward(library), calls=1, sleep_cycles=200_000_000)
    b, by = bound(nbytes, sum(2 * x.shape[0] * x.shape[1] * w.shape[1] for x, w, _ in calls))
    # a launch that reads no weight: what a skinny call costs beyond its bytes
    x, w, _ = calls[0]
    x0, w0 = x[:, :0], w[:0]
    floor = time_ms(lambda: arype.arype_matmul(x0, w0))
    lib = "torch.matmul" if x.dtype == w.dtype else "torch.matmul(x.float(), w).to()"
    log(f"[kernels] mm_fused decode forward, {label}, cold L2 ({len(calls)} matmuls over "
        f"{layers} distinct layers + head, {nbytes / 1e9:.3f} GB, one call each): kernel "
        f"{t:.4f} ms, {lib} {tl:.4f} ms ({t / tl:.2f}x), bound {b:.4f} ms ({by}), "
        f"{nbytes / t / 1e6:.1f} GB/s; a call with K = 0 at ({x.shape[0]},0,{w.shape[1]}) "
        f"{floor * 1e3:.2f} us")
    return dict(ms=t, library_ms=tl, bound_ms=b, bound_by=by)


def greedy_single(torch, model, params, prompt, max_new: int, cache_len: int,
                  extra: dict | None = None):
    """The single-request greedy reference: batch 1, prefill then decode
    (``extra``: more inputs of the prefill's batch, as the request's image
    embeddings (1, T, d)).  Returns its tokens and, at each, the gap of its
    top two logits as a share of max|logit|."""
    cache = model.init_cache(1, cache_len)
    v = model.cfg.vocab_size
    toks, gaps = [], []

    def take(logits):
        top2 = logits.topk(2).values
        gaps.append(((top2[0] - top2[1]) / logits.abs().max()).item())
        toks.append(int(logits.argmax()))

    logits, cache = model.prefill(params, {"tokens": torch.as_tensor(prompt[None]).to(CARD),
                                           **(extra or {})}, cache)
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
             alone: bool = False, shapes: dict | None = None, batch1: bool = True):
    """Serve the requests with every launch count at 0 just before and read
    just after; tokens must equal each request's single-request greedy run,
    and launches the prediction: a forward's routed matmuls
    (``lm_forward_matmuls``), every one on the AryPE at these shapes
    (``mm_fused``), one forward a prefill and one a decode step (every wave of ``max_new``-token
    requests takes ``max_new - 1`` steps), and one ``flash_fwd`` an
    attention layer a prefill.  With ``near_tie`` (a share of max|logit|) a request may leave
    its batch-1 tokens where that run's top two logits were closer than it
    (counted; the rest of that request is not compared): at batch 1 the
    plain PyTorch decode attention sums in another order than at the
    serve's slots (the matmuls agree bit for bit: the VPE's one-row
    projections run ``mm_fused``'s skinny kernel).  With ``alone`` the
    tokens must also equal, exactly, each request served alone by an engine
    of the same config (the same shapes and placements: no kernel's rows
    depend on the other slots).  Returns (launch counts, the engine's stats,
    the batch-1 runs' launch counts, near ties).  With ``shapes`` the
    serve's and the batch-1 runs' recorded matmuls are noted there
    (``note_shapes``).  ``batch1=False`` leaves the batch-1 runs out (their
    launch counts then all 0)."""
    refs_alone = [serve_alone(serving, cfg, params, p, serve, max_new) for p in prompts] \
        if alone else None
    kernels.reset_launches()
    with record_routes() as single_routes:
        refs = [greedy_single(torch, lm_mod.LM(cfg, device=CARD), params, p, max_new,
                              serve["cache_len"]) for p in prompts] if batch1 else None
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
    for r, (ref, gaps) in zip(reqs, refs or ()):
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
    matmuls, flash_layers = lm_forward_matmuls(cfg), attention_layers(cfg)
    per_forward = len(matmuls)
    forwards = len(reqs) + waves * (max_new - 1)
    want = dict.fromkeys(kernels.KERNELS, 0)
    want["mm_fused"] = per_forward * forwards
    want["flash_fwd"] = flash_layers * len(reqs)
    checked = {(k, n) for _, k, n in matmuls}
    if {(r.k, r.n) for r in routes} != checked:
        raise AssertionError(f"the serve's matmuls {sorted({(r.k, r.n) for r in routes})} "
                             f"are not the checked {sorted(checked)}")
    if shapes is not None:
        note_shapes(kernels, routes, "serve", shapes)
        note_shapes(kernels, single_routes, "batch 1", shapes)
    recorded = kernels.matmul_launches(routes)
    recorded["flash_fwd"] = flash_layers * st.prefills
    if counts != want or recorded != want or st.prefills + st.decode_steps != forwards:
        raise AssertionError(f"launches {counts}, recorded routes {recorded}, "
                             f"{st.prefills} prefills + {st.decode_steps} decode steps: "
                             f"predicted {want} over {forwards} forwards")
    log(f"  {len(done)}/{len(reqs)} requests done"
        + (f", tokens equal to each one's single-request greedy run"
           f"{f' except {ties} near ties' if near_tie is not None else ''}" if batch1 else "")
        + "; "
        f"{st.prefills} prefills, {st.decode_steps} decode steps, {st.tokens} tokens")
    log(f"  prefill {st.prefill_s / st.prefills * 1e3:.3f} ms per admit ({serve['batch_slots']}-"
        f"slot batch, prompts {min(map(len, prompts))}-{max(map(len, prompts))}), decode "
        f"{st.decode_s / st.decode_steps * 1e3:.3f} ms per step, {st.tok_per_s:.1f} generated tok/s")
    log(f"  launches {counts} = predicted: {per_forward} mm_fused a forward x {forwards} "
        f"forwards, {flash_layers} flash_fwd a prefill x {len(reqs)}")
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


def masked_phase(torch, ff, fx, ft, kernels, record_routes, checks, TrafficConfig,
                 TrafficGenerator, OctopusPipeline, PipelineConfig, mlp, cnn, card) -> dict:
    """Bucketed, keep-masked steps at 256 and 8192 packets, card against
    CPU; the 8192 bucket folds through ``flow_update``'s chunked variant.
    Then each engine kernel at the buckets' shapes against its plain
    version; returns each kernel's largest error there."""
    log(f"[pipeline masked] CNN f32, {PIPE}; warm_bucket{BUCKETS}, step_masked on ragged keep "
        f"masks, card vs CPU")
    gpu = OctopusPipeline(mlp, cnn, PipelineConfig(**PIPE))
    cpu = OctopusPipeline(mlp, cnn, PipelineConfig(**PIPE), device="cpu")
    for bucket in BUCKETS:
        gpu.warm_bucket(bucket)
    gen = TrafficGenerator(TrafficConfig(**TRAFFIC), device="cpu")
    rng = torch.Generator().manual_seed(5)
    near = flipped = 0
    shapes = {}
    for step in range(MASKED_STEPS):
        bucket = BUCKETS[step % len(BUCKETS)]
        parts = [gen.next_batch() for _ in range(max(1, bucket // TRAFFIC["batch_size"]))]
        batch = ft.PacketBatch(*(torch.cat(leaves)[:bucket] for leaves in zip(*parts)))
        keep = torch.rand(bucket, generator=rng) < (0.5 + 0.4 * torch.rand(1, generator=rng))
        plan = ff.flow_plan(bucket, PIPE["table_size"])
        before = ff.FLOW_UPDATE.launches
        with record_routes() as routes:
            out_g = gpu.step_masked(batch, keep)
        launched = ff.FLOW_UPDATE.launches - before
        note_shapes(kernels, routes, f"bucket {bucket}", shapes)
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
    return check_recorded(checks, shapes, "the masked steps")


def lane_steps(torch, kernels, record_routes, pipe, batches, label: str, card: str,
               shapes: dict, rounds: int = 1):
    """Warm up, record one step's matmuls (their shapes into ``shapes``),
    then run the batches with the launch counts set to 0 just before and
    read just after: they must equal what the recorded routes launch plus
    ``rounds`` ``flow_update`` a step.  Prints pkt/s, step us with its host /
    exposed device split and the launches a step.  Returns the stats."""
    pipe.warmup()
    with record_routes() as routes:
        pipe.step(batches[0])
    note_shapes(kernels, routes, label, shapes)
    pipe.reset()
    kernels.reset_launches()
    stats = pipe.run(batches, steps=len(batches))
    counts = kernels.launches()
    want = kernels.matmul_launches(routes, len(batches))
    want["flow_update"] += rounds * len(batches)
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts}, expected {want}")
    n = len(batches)
    log(f"  {label}: {stats.pkt_per_s:.1f} pkt/s, step {stats.step_us:.1f} us (host "
        f"{stats.host_s / n * 1e6:.1f} / exposed device {stats.device_s / n * 1e6:.1f}), "
        f"{stats.dispatches} dispatches, flows {stats.flows}, evicted {stats.evicted}, spilled "
        f"{stats.spilled}, promoted {stats.promoted}, fallback steps {stats.fallback_steps}; "
        f"launches a step { {k: v / n for k, v in counts.items() if v} } [{card}]")
    return stats


def decided_alike(torch, fx, label: str, cpu, out_g, out_c, batch) -> tuple[int, int]:
    """Packet verdicts and flow classes of a card step against the CPU's:
    equal except where the CPU's logits are within ``NEAR_TIE`` of a tie
    (packet logits on the batch, flow logits on the drained rows in one
    call).  Returns ``(near ties, decisions that differ)``."""
    logits = cpu.packet_engine.fn(cpu.packet_engine.params, fx.packet_meta_features(batch))
    tie = (logits[:, 1] - logits[:, 0]).abs() < NEAR_TIE
    differ = out_g.pkt_actions.cpu() != out_c.pkt_actions
    mask = out_c.drained.mask
    flow_x = cpu.flow_engine.prep(out_c.drained.series, out_c.drained.payload)
    top2 = cpu.flow_engine.fn(cpu.flow_engine.params, flow_x).topk(2, dim=-1).values
    flow_tie = ((top2[:, 0] - top2[:, 1]) < NEAR_TIE) & mask
    flow_differ = (out_g.flow_cls.cpu() != out_c.flow_cls) & mask
    if (differ & ~tie).any() or (flow_differ & ~flow_tie).any():
        raise AssertionError(f"{label}: decisions differ away from a near tie")
    return int(tie.sum() + flow_tie.sum()), int(differ.sum() + flow_differ.sum())


def lanes_card_vs_cpu(torch, fx, gpu, cpu, batches, label: str) -> None:
    """The card's and the CPU's sharded pipelines over the same batches: the
    (S, F, ...) state (and cold lanes), drained rows and step counters bit for
    bit every step, decisions except near ties, the rule table and the
    stats counters."""
    near = flipped = 0
    for step, batch in enumerate(batches):
        out_g, out_c = gpu.step(batch), cpu.step(batch)
        same_tree(torch, f"{label} step {step} state", gpu.state, cpu.state)
        same_tree(torch, f"{label} step {step} drained", out_g.drained, out_c.drained)
        for name in ("new_flows", "evicted", "fallback_slots", "spilled", "promoted"):
            if int(getattr(out_g, name)) != int(getattr(out_c, name)):
                raise AssertionError(f"{label} step {step}: {name} differs")
        n, f = decided_alike(torch, fx, f"{label} step {step}", cpu, out_g, out_c, batch)
        near, flipped = near + n, flipped + f
    if not flipped and gpu.rules.rules != cpu.rules.rules:
        raise AssertionError(f"{label}: rule tables differ with identical decisions")
    for name in ("packets", "flows", "new_flows", "evicted", "spilled", "promoted",
                 "fallback_steps", "dispatches", "padded"):
        if getattr(gpu.stats, name) != getattr(cpu.stats, name):
            raise AssertionError(f"{label}: stats.{name} differs")
    log(f"  {label}: state, drained rows and counters equal the CPU's over {len(batches)} "
        f"steps (flows {cpu.stats.flows}, evicted {cpu.stats.evicted}, spilled "
        f"{cpu.stats.spilled}, promoted {cpu.stats.promoted}); decisions identical except "
        f"{flipped} of {near} near ties")


def drained_union(out, dst: dict, classes: dict) -> None:
    """Each drained flow's snapshot (slot, count, leaves) and its flow class,
    by tuple."""
    for i in out.drained.mask.nonzero().squeeze(1).tolist():
        tid = int(out.drained.tuple_id[i])
        dst.setdefault(tid, []).append(tuple(
            getattr(out.drained, name)[i].cpu().reshape(-1).tolist()
            for name in ("slots", "count", "features", "series", "sizes", "payload")))
        classes.setdefault(tid, []).append(int(out.flow_cls[i]))


def sharded_phase(torch, fx, ft, kernels, record_routes, checks, TrafficConfig,
                  TrafficGenerator, OctopusPipeline, ShardedOctopusPipeline, PipelineConfig, mlp,
                  cnn, int8, card, profile: bool = False) -> dict:
    """The sharded lanes as one lane-batched bank: S = 1, 2, 4 on the
    collision-free traffic (timed beside the single lane, card vs CPU, and
    against the single lane where the exactness preconditions hold; with
    ``profile`` each S's device-busy share over 8 traced steps), then the
    lane-0 collision attack in rounds, a two-level run and an int8 run, each
    card vs CPU.  Last, each engine kernel against its plain version at
    every per-lane shape those runs' recorded routes name (the flow engine
    at ``max_ready / S`` rows moves layers between engines); returns each
    kernel's largest error there."""
    batches = make_batches(TrafficConfig, TrafficGenerator, TRAFFIC, SHARDED_STEPS, "cpu")
    cpu_batches = batches[:SHARDED_CPU_STEPS]
    log(f"[pipeline sharded] CNN f32, {PIPE}, traffic {TRAFFIC}, lanes {SHARDS}: "
        f"{SHARDED_STEPS} steps timed, {SHARDED_CPU_STEPS} card vs CPU and against the single "
        "lane")
    shapes = {}
    single = OctopusPipeline(mlp, cnn, PipelineConfig(**PIPE))
    lane_steps(torch, kernels, record_routes, single, batches, "single lane (OctopusPipeline)",
               card, shapes)
    single.reset()
    single_acts, single_union, single_cls, single_backlog = [], {}, {}, 0
    for batch in cpu_batches:
        out = single.step(batch)
        single_acts.append(out.pkt_actions.cpu())
        drained_union(out, single_union, single_cls)
        single_backlog += int(ft.ready_mask(single.state, top_n=single.cfg.top_n).sum())
    for S in SHARDS:
        label = f"{S} lane{'s' if S > 1 else ''}"
        pipe = ShardedOctopusPipeline(mlp, cnn, PipelineConfig(**PIPE), num_shards=S)
        stats = lane_steps(torch, kernels, record_routes, pipe, batches, label, card, shapes)
        if stats.dispatches != SHARDED_STEPS:
            raise AssertionError(f"{label}: {stats.dispatches} dispatches")
        if profile:
            profile_steps(torch, pipe, batches[:8], stats.step_us)
        del pipe
        gpu = ShardedOctopusPipeline(mlp, cnn, PipelineConfig(**PIPE), num_shards=S)
        cpu = ShardedOctopusPipeline(mlp, cnn, PipelineConfig(**PIPE), num_shards=S,
                                     device="cpu")
        lanes_card_vs_cpu(torch, fx, gpu, cpu, cpu_batches, f"{label} card vs cpu")
        if not cpu.stats.flows:
            raise AssertionError(f"{label}: no flow drained in {SHARDED_CPU_STEPS} steps")
        # the JAX package's exactness preconditions: no slot shared by two
        # live flows of different lanes (collision-free traffic shares none;
        # a new flow may still evict a dead one of another lane, which only
        # leaves a stale row that never drains) and no ready flow held back
        gpu.reset()
        union, classes, backlog, same_acts = {}, {}, 0, True
        for batch, acts in zip(cpu_batches, single_acts):
            out = gpu.step(batch)
            same_acts &= torch.equal(out.pkt_actions.cpu(), acts)
            drained_union(out, union, classes)
            backlog += int((gpu.state.count >= cpu.cfg.top_n).sum())
        if not TrafficConfig(**TRAFFIC).collision_free or backlog or single_backlog:
            log(f"  {label} vs the single lane: preconditions do not hold (collision-free "
                f"{TrafficConfig(**TRAFFIC).collision_free}, ready flows held back {backlog} "
                f"sharded / {single_backlog} single): not compared")
        elif union != single_union or not same_acts:
            raise AssertionError(f"{label}: drained flows or packet verdicts differ from the "
                                 "single lane's")
        else:
            n = sum(map(len, union.values()))
            same_cls = sum(a == b for t in classes for a, b in zip(classes[t], single_cls[t]))
            log(f"  {label} vs the single lane: the {n} drained flow snapshots and every packet "
                f"verdict equal over {SHARDED_CPU_STEPS} steps, flow classes equal on {same_cls} "
                f"of {n} (each lane's flow engine runs at its own M, so its routes may differ); "
                f"dead flows evicted: {single.stats.evicted} single, {gpu.stats.evicted} sharded")
        del gpu, cpu
        torch.cuda.empty_cache()
    # the attack: every flow in lane 0, 4 rounds of 256 a step
    attack = make_batches(TrafficConfig, TrafficGenerator, LANE_ATTACK, 16, "cpu")
    if any((ft.shard_of(b.tuple_hash, 4) != 0).any() for b in attack):
        raise AssertionError("the lane-0 attack put a packet outside lane 0")
    rounds = PIPE["batch_size"] // ATTACK_LANE_BATCH
    kw = dict(num_shards=4, lane_batch=ATTACK_LANE_BATCH)
    log(f"  collision attack {LANE_ATTACK}, 4 lanes, lane_batch {ATTACK_LANE_BATCH}:")
    pipe = ShardedOctopusPipeline(mlp, cnn, PipelineConfig(**PIPE), **kw)
    stats = lane_steps(torch, kernels, record_routes, pipe, attack, "attack", card, shapes,
                       rounds=rounds)
    if stats.dispatches != rounds * len(attack) or stats.fallback_steps != len(attack):
        raise AssertionError(f"attack: {stats.dispatches} dispatches, "
                             f"{stats.fallback_steps} fallback steps")
    lanes_card_vs_cpu(torch, fx, ShardedOctopusPipeline(mlp, cnn, PipelineConfig(**PIPE), **kw),
                      ShardedOctopusPipeline(mlp, cnn, PipelineConfig(**PIPE), device="cpu",
                                             **kw), attack[:8], "attack card vs cpu")
    del pipe
    # two-level lanes on the colliding traffic
    spill = make_batches(TrafficConfig, TrafficGenerator, SPILL_TRAFFIC, LANE_SPILL_STEPS, "cpu")
    cfg = PipelineConfig(**PIPE, cold_size=LANE_COLD, cold_policy="age")
    log(f"  two-level, 4 lanes, cold_size {LANE_COLD} a lane (age), traffic {SPILL_TRAFFIC}:")
    pipe = ShardedOctopusPipeline(mlp, cnn, cfg, num_shards=4)
    stats = lane_steps(torch, kernels, record_routes, pipe, spill, "two-level", card, shapes)
    if not (stats.spilled and stats.promoted):
        raise AssertionError(f"two-level: spilled {stats.spilled}, promoted {stats.promoted}")
    del pipe
    torch.cuda.empty_cache()
    lanes_card_vs_cpu(torch, fx, ShardedOctopusPipeline(mlp, cnn, cfg, num_shards=4),
                      ShardedOctopusPipeline(mlp, cnn, cfg, num_shards=4, device="cpu"), spill,
                      "two-level card vs cpu")
    torch.cuda.empty_cache()
    # int8 at 2 lanes
    log("  int8 (the phase-5 full table), 2 lanes:")
    pipe = ShardedOctopusPipeline(mlp, cnn, PipelineConfig(**PIPE), num_shards=2, config=int8)
    lane_steps(torch, kernels, record_routes, pipe, batches, "int8", card, shapes)
    if kernels.launches()["vpe_mm"] or kernels.launches()["mm_fused"]:
        raise AssertionError("the int8 lanes launched an f32 engine kernel")
    lanes_card_vs_cpu(
        torch, fx, ShardedOctopusPipeline(mlp, cnn, PipelineConfig(**PIPE), num_shards=2,
                                          config=int8),
        ShardedOctopusPipeline(mlp, cnn, PipelineConfig(**PIPE), num_shards=2, config=int8,
                               device="cpu"), cpu_batches, "int8 card vs cpu")
    return check_recorded(checks, shapes, "the lanes")


class Replay:
    """A client's requests made before the run, served through
    ``serve_stream`` as a generator's are: the run then times the frontend
    without the generator's Python work (which holds the interpreter lock
    while an offloaded dispatch runs)."""

    def __init__(self, gen, n: int):
        self.client_id = gen.client_id
        self._batches = list(gen.batches(n))

    def batches(self, n: int):
        return iter(self._batches[:n])


def service_phase(torch, fx, build, serving, kernels, record_routes, checks, TrafficConfig,
                  TrafficGenerator, OctopusPipeline, ShardedOctopusPipeline, PipelineConfig, mlp,
                  cnn, card) -> dict:
    """``OctopusService`` over the single lane and 4 lanes, offload on and
    off, with the clients' generators running live and replayed: 8
    closed-loop clients, ragged sizes; no kernel-library build and no
    unwarmed bucket after ``start``, the queue drained; inline, every
    request's verdicts and the rule table equal the CPU port's on the same
    script.  Then each engine kernel against its plain version at the
    shapes a masked step of every bucket runs it at, on both pipelines;
    returns each kernel's largest error there."""
    import asyncio

    log(f"[service] CNN f32, {PIPE}; buckets {SERVICE_BUCKETS}, {len(SERVICE_SIZES)} "
        f"closed-loop clients of {SERVICE_SIZES} packets, {SERVICE_REQUESTS} requests each")
    live = lambda: [TrafficGenerator(TrafficConfig(
        batch_size=n, active_flows=PIPE["table_size"] // 16, table_size=PIPE["table_size"],
        seed=100 + i, client_id=i), device="cpu") for i, n in enumerate(SERVICE_SIZES)]
    replayed = lambda: [Replay(g, SERVICE_REQUESTS) for g in live()]
    requests = [list(g.batches(SERVICE_REQUESTS)) for g in live()]
    budget = 4 * sum(SERVICE_SIZES)
    shapes = {}

    def serve(pipe, offload: bool, clients: list):
        svc = serving.OctopusService(pipe, serving.ServiceConfig(
            buckets=SERVICE_BUCKETS, depth_budget=budget, offload=offload))
        seen = []
        plain = pipe.step_masked

        def watched(batch, keep):
            seen.append((int(batch.ts.shape[0]), set(pipe._warm_buckets)))
            return plain(batch, keep)

        async def run():
            async with svc:
                lib = (build._lib, build.build_seconds, set(pipe._warm_buckets))
                pipe.step_masked = watched
                outs = await asyncio.gather(*(serving.serve_stream(svc, g, requests=SERVICE_REQUESTS)
                                              for g in clients))
                depth = svc.queue_depth
            return outs, lib, depth

        outs, (lib, built, warmed), depth = asyncio.run(run())
        del pipe.step_masked
        if (build._lib, build.build_seconds) != (lib, built):
            raise AssertionError("the kernel library was built after start")
        if any(b not in warmed or before != warmed for b, before in seen) or not seen:
            raise AssertionError(f"a dispatch rode a bucket start had not warmed: {seen}")
        if depth or svc.stats.shed or svc.stats.served != SERVICE_REQUESTS * sum(SERVICE_SIZES):
            raise AssertionError(f"queue depth {depth}, shed {svc.stats.shed}, served "
                                 f"{svc.stats.served}")
        return svc, outs

    for label, make in (
            ("single lane", lambda dev: OctopusPipeline(mlp, cnn, PipelineConfig(**PIPE),
                                                       device=dev)),
            ("4 lanes", lambda dev: ShardedOctopusPipeline(mlp, cnn, PipelineConfig(**PIPE),
                                                          num_shards=4, device=dev))):
        for offload, source, gens in ((True, "live", live), (False, "live", live),
                                      (True, "replayed", replayed),
                                      (False, "replayed", replayed)):
            pipe = make(None)
            svc, outs = serve(pipe, offload, gens())
            s = svc.stats
            log(f"  {label}, offload {'on' if offload else 'off'}, clients {source}: "
                f"{s.dispatches} dispatches, "
                f"{s.coalesced} coalesced, {s.padded} padded, {s.pkt_per_s:.1f} pkt/s; wait p50 "
                f"{s.wait.p50:.1f} / p99 {s.wait.p99:.1f} us, end to end p50 {s.e2e.p50:.1f} / "
                f"p99 {s.e2e.p99:.1f} us; a dispatch host {s.host_us:.1f} / step "
                f"{s.device_us:.1f} us; pipeline step {pipe.stats.step_us:.1f} us (host "
                f"{pipe.stats.host_us:.1f} / exposed device {pipe.stats.device_us:.1f}) [{card}]")
            if offload or source != "live":
                continue
            cpu = make("cpu")
            cpu_svc, cpu_outs = serve(cpu, offload, live())
            near = flipped = 0
            for client, (got, want, batches) in enumerate(zip(outs, cpu_outs, requests)):
                for k, (g, w, batch) in enumerate(zip(got, want, batches)):
                    if g.buckets != w.buckets:
                        raise AssertionError(f"client {client} request {k}: buckets "
                                             f"{g.buckets}, CPU {w.buckets}")
                    logits = cpu.packet_engine.fn(cpu.packet_engine.params,
                                                  fx.packet_meta_features(batch))
                    tie = ((logits[:, 1] - logits[:, 0]).abs() < NEAR_TIE).numpy()
                    differ = g.pkt_actions != w.pkt_actions
                    if (differ & ~tie).any():
                        raise AssertionError(f"client {client} request {k}: verdicts differ "
                                             "away from a near tie")
                    near, flipped = near + int(tie.sum()), flipped + int(differ.sum())
            if not flipped and pipe.rules.rules != cpu.rules.rules:
                raise AssertionError(f"{label}: rule tables differ with identical verdicts")
            for name in ("dispatches", "coalesced", "padded"):
                if getattr(s, name) != getattr(cpu_svc.stats, name):
                    raise AssertionError(f"{label}: {name} differs from the CPU's")
            log(f"    card vs cpu (inline): every request's buckets and verdicts equal except "
                f"{flipped} of {near} near ties; rule tables "
                f"{'equal' if pipe.rules.rules == cpu.rules.rules else 'differ at the ties'}")
            del cpu
        # the shapes a dispatch of each bucket runs the engines at
        for bucket in SERVICE_BUCKETS:
            batch, = make_batches(TrafficConfig, TrafficGenerator, dict(TRAFFIC, batch_size=bucket),
                                  1, "cpu")
            with record_routes() as routes:
                pipe.step_masked(batch, torch.ones(bucket, dtype=torch.bool))
            note_shapes(kernels, routes, f"{label} bucket {bucket}", shapes)
        del pipe
        torch.cuda.empty_cache()
    # the same masked step on this thread and on a one-thread executor, as
    # the service dispatches inline and offloaded, with nothing else running
    from concurrent.futures import ThreadPoolExecutor

    top = SERVICE_BUCKETS[-1]
    batches = make_batches(TrafficConfig, TrafficGenerator, dict(
        batch_size=top, active_flows=PIPE["table_size"] // 2, table_size=PIPE["table_size"],
        collision_free=False, seed=3), 8, "cpu")
    keep = torch.ones(top, dtype=torch.bool)
    pipe = OctopusPipeline(mlp, cnn, PipelineConfig(**PIPE))
    pipe.warm_bucket(top)
    times = {"this thread": [], "executor": []}
    with ThreadPoolExecutor(max_workers=1) as pool:
        for where in ("this thread", "executor", "executor", "this thread"):
            t0 = time.perf_counter()
            for batch in batches:
                if where == "executor":
                    pool.submit(pipe.step_masked, batch, keep).result()
                else:
                    pipe.step_masked(batch, keep)
            times[where].append((time.perf_counter() - t0) / len(batches) * 1e3)
    log(f"  a {top}-packet masked step alone, ms a call (runs in turns a, b, b, a): "
        + "; ".join(f"{where} {', '.join(f'{t:.2f}' for t in ts)}" for where, ts in times.items())
        + f" [{card}]")
    return check_recorded(checks, shapes, "the service's buckets")


def sync(torch) -> None:
    if CARD != "cpu":
        torch.cuda.synchronize()


def wall_ms(torch, fn, reps: int) -> float:
    """Host-clock ms of one call that ends in a device sync, median of
    ``reps`` after a warm call."""
    fn()
    sync(torch)
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(torch)
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples)


def expect_launches(kernels, want: dict, label: str) -> dict:
    """The launch counts since the last reset must be ``want`` (every other
    kernel 0); returns the counts."""
    counts = kernels.launches()
    full = dict.fromkeys(counts, 0)
    full.update(want)
    if counts != full:
        raise AssertionError(f"{label}: launch counts {counts}, expected {full}")
    return counts


def counts_text(counts: dict) -> str:
    return str({k: v for k, v in counts.items() if v})


def extractor_phase(torch, kernels, card: str):
    """The offline extractor over whole traces on the card and on the CPU:
    ``extract_segmented``, ``extract_scan`` and ``extract_scan`` with the
    fold replayed (``use_pallas``), bit for bit with each other and card
    against CPU, one ``flow_update`` launch for each of the two folding
    modes; the replay's fold (its dropped packets spread over the chunks)
    and the same packets in slot order (as the segmented merge feeds it)
    against the plain fold at the trace's P, and its kernel and plain times
    at the first trace's P; Mpkt/s of each mode.  Returns the first trace's
    packets and scanned state on the CPU."""
    from repro_torch.core import flow_tracker as ft
    from repro_torch.core.feature_extractor import ExtractorConfig, FeatureExtractor
    from repro_torch.data import PacketTraceConfig, synth_packet_trace
    from repro_torch.kernels.flow_features import ops as ff

    t_phase = time.perf_counter()
    log(f"[extractor] FeatureExtractor({ExtractorConfig()}) over whole traces: "
        "extract_segmented, extract_scan, extract_scan with the fold replayed (use_pallas); "
        "card vs CPU")
    extractors = {dev: (FeatureExtractor(device=dev),
                        FeatureExtractor(ExtractorConfig(use_pallas=True), device=dev))
                  for dev in (CARD, "cpu")}
    program = extractors[CARD][0].program
    first = None
    for name, cfg in EXTRACT_TRACES.items():
        packets_c, *_ = synth_packet_trace(PacketTraceConfig(**cfg), device="cpu")
        packets_g = ft.PacketBatch(*(a.to(CARD) for a in packets_c))
        p = int(packets_c.ts.shape[0])
        t_trace = time.perf_counter()
        runs, outs = {}, {}
        for dev, packets in ((CARD, packets_g), ("cpu", packets_c)):
            plain, replay = extractors[dev]
            runs[dev] = {
                "segmented": lambda plain=plain, packets=packets: plain.extract_segmented(packets),
                "scan": lambda plain=plain, packets=packets: plain.extract_scan(
                    plain.init_state(), packets),
                "scan + replay": lambda replay=replay, packets=packets: replay.extract_scan(
                    replay.init_state(), packets)}
        for fn in runs[CARD].values():
            fn()  # warm: the allocator at this P
        sync(torch)
        kernels.reset_launches()
        outs[CARD] = {mode: fn() for mode, fn in runs[CARD].items()}
        sync(torch)
        counts = expect_launches(kernels, {"flow_update": 2}, f"[extractor] {name}")
        outs["cpu"] = {mode: fn() for mode, fn in runs["cpu"].items()}
        for dev, got in outs.items():
            (scan, scan_outs), (rep, rep_outs) = got["scan"], got["scan + replay"]
            same_tree(torch, f"{name} {dev}: replayed scan state", scan, rep)
            same_tree(torch, f"{name} {dev}: replayed scan outputs", scan_outs, rep_outs)
            for leaf, a, b in zip(("features", "series", "sizes", "payload", "count"),
                                  got["segmented"], (scan.features, scan.series, scan.sizes,
                                                     scan.payload, scan.count)):
                if not torch.equal(a, b):
                    raise AssertionError(f"{name} {dev}: segmented {leaf} differs from the scan")
        for mode in ("scan", "scan + replay"):
            for part, a, b in zip(("state", "outputs"), outs[CARD][mode], outs["cpu"][mode]):
                same_tree(torch, f"{name} {mode} {part}, card vs CPU", a, b)
        for a, b in zip(outs[CARD]["segmented"], outs["cpu"]["segmented"]):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"{name}: segmented extraction differs card vs CPU")
        _, seg = extractors[CARD][0].segmented_update(extractors[CARD][0].init_state(), packets_g)
        fallback = int(seg.fallback_slots)
        if (fallback > 0) != (not cfg.get("collision_free", True)):
            raise AssertionError(f"{name}: {fallback} slots took the scan fallback")
        # the fold at this P against its plain version: the replay's input
        # (packets before a slot's last establish dropped, wherever they lie)
        # and the same packets in slot order, as the segmented merge feeds it
        replay = extractors[CARD][1]
        scan_outs = outs[CARD]["scan"][1]
        slots, meta, table = replay.replay_inputs(replay.init_state(), packets_g, scan_outs)
        order = torch.sort(slots, stable=True).indices
        plan = ff.flow_plan(p, table.shape[0])
        dropped = int((slots == table.shape[0]).sum())
        for label, args in (("replay", (program, slots, meta, table)),
                            ("slot order", (program, slots[order], meta[order], table))):
            got = ff.flow_feature_update(*args)
            want = ff.flow_feature_update_plain(*args)
            if not torch.equal(got, want):
                raise AssertionError(f"{name}: flow_update ({label}) differs from its plain fold")
        chunks = -(-p // plan.cap)
        log(f"  {name}: {p} packets, {plan.variant} flow_update in {chunks} chunks of "
            f"{plan.cap} over {plan.ctas} CTAs, {dropped} dropped by the replay: bit for bit "
            "with the plain fold (replay and slot order)")
        times = {mode: wall_ms(torch, fn, EXTRACT_REPS) for mode, fn in runs[CARD].items()}
        log(f"  {name}: every mode bit for bit with the others and card vs CPU; scan fallback "
            f"on {fallback} slots; launches {counts_text(counts)}; "
            + ", ".join(f"{mode} {ms:.3f} ms ({p / ms / 1e3:.3f} Mpkt/s)"
                        for mode, ms in times.items())
            + f" [{card}; the paper's FPGA extractor: {PAPER_MPKT_S} Mpkt/s at 125 MHz]; "
            f"{time.perf_counter() - t_trace:.1f} s with the CPU's runs")
        if first is None:
            args = (program, slots, meta, table)
            ms = time_ms(lambda: ff.flow_feature_update(*args))
            plain_ms = time_ms(lambda: ff.flow_feature_update_plain(*args), calls=2, reps=3)
            nbytes = 4 * (16 * 3 + p + 13 * p + 16 * table.shape[0]) + 4 * 16 * table.shape[0]
            b, _ = bound(nbytes, 16 * (p - dropped))  # 32-bit ALU ops at the f32 rate
            log(f"  flow_update at P={p} ({chunks} chunks, {dropped} dropped): kernel "
                f"{ms:.5f} ms, plain {plain_ms:.5f} ms, bound {b:.6f} ms ({nbytes} bytes)")
            first = (packets_c, outs["cpu"]["scan"][0])
    log(f"  [extractor] {time.perf_counter() - t_phase:.1f} s")
    return first


def paths_phase(torch, kernels, record_routes, checks, mlp, cnn, tf, packets, state,
                card: str) -> dict:
    """``PacketPath`` at each batch of ``PATH_BATCHES`` and ``FlowPath`` at
    ``FLOW_PATHS`` on the flows of the 8k-table trace's extraction, card
    against CPU (decisions except near ties, the rule tables), with the
    launches of the timed calls as the recorded routes say and the
    ``PathStats`` host/device split.  Then each engine kernel against its
    plain version at every shape the paths ran it at; returns each kernel's
    largest error there."""
    from repro_torch.core import flow_tracker as ft
    from repro_torch.core.feature_extractor import packet_meta_features
    from repro_torch.serving import FlowPath, PacketPath

    t_phase = time.perf_counter()
    log(f"[paths] PacketPath (MLP) at batches {list(PATH_BATCHES)}, FlowPath {FLOW_PATHS} on "
        "the 8k-table trace's flows; card vs CPU")
    shapes = {}
    for batch, calls in PATH_BATCHES.items():
        pk = ft.PacketBatch(*(a[:batch] for a in packets))
        pk_g = ft.PacketBatch(*(a.to(CARD) for a in pk))
        gpu, cpu = PacketPath(mlp, device=CARD), PacketPath(mlp, device="cpu")
        with record_routes() as routes:
            gpu.warmup(batch)
        note_shapes(kernels, routes, f"packet path batch {batch}", shapes)
        kernels.reset_launches()
        for _ in range(calls):
            acts = gpu.process(pk_g)
        counts = expect_launches(kernels, kernels.matmul_launches(routes, calls),
                                 f"[paths] packet path batch {batch}")
        want = cpu.process(pk)
        logits = cpu.engine.fn(cpu.params, packet_meta_features(pk))
        tie = ((logits[:, 1] - logits[:, 0]).abs() < NEAR_TIE).numpy()
        differ = acts != want
        if (differ & ~tie).any():
            raise AssertionError(f"packet path batch {batch}: verdicts differ away from a tie")
        actions = lambda path: {fid: rule["action"] for fid, rule in path.rules.rules.items()}
        if not differ.any() and actions(gpu) != actions(cpu):
            raise AssertionError(f"packet path batch {batch}: rule tables differ")
        s = gpu.stats
        log(f"  packet path, batch {batch}: {s.latency_us:.2f} us a call (host "
            f"{s.host_us:.2f} / device wait {s.device_us:.2f}), {s.latency_us / batch * 1e3:.1f} "
            f"ns a packet, {s.throughput:.1f} pkt/s over {s.calls} calls; verdicts equal the "
            f"CPU's except {int(differ.sum())} of {int(tie.sum())} near ties; launches a call "
            f"{ {k: v / calls for k, v in counts.items() if v} } [{card}; the paper's FPGA: "
            f"{PAPER_PKT_NS} ns a packet]")
    live = state.count > 0
    ids = state.tuple_id[live].numpy()
    for model, flows in FLOW_PATHS:
        params = cnn if model == "cnn" else tf
        gpu = FlowPath(params, model, device=CARD)
        cpu = FlowPath(params, model, device="cpu")
        # both devices take the CPU's prepared input (log1p differs between them)
        x = cpu.engine.prep(state.series[live][:flows], state.payload[live][:flows])
        if x.shape[0] != flows:
            raise AssertionError(f"flow path: {x.shape[0]} live flows, not {flows}")
        x_g = x.to(CARD)
        with record_routes() as routes:
            gpu.warmup(flows)
        note_shapes(kernels, routes, f"flow path {model} {flows}", shapes)
        kernels.reset_launches()
        for _ in range(FLOW_CALLS):
            cls = gpu.process(x_g, ids[:flows])
        counts = expect_launches(kernels, kernels.matmul_launches(routes, FLOW_CALLS),
                                 f"[paths] flow path {model} {flows}")
        want = cpu.process(x, ids[:flows])
        logits = cpu.engine.fn(cpu.params, x)
        gap = NEAR_TIE if model == "cnn" else TF_LOGIT_TOL["f32"] * logits.abs().max().item()
        top2 = logits.topk(2, dim=-1).values
        tie = ((top2[:, 0] - top2[:, 1]) < gap).numpy()
        differ = cls != want
        if (differ & ~tie).any():
            raise AssertionError(f"flow path {model} {flows}: classes differ away from a tie")
        s = gpu.stats
        log(f"  flow path, {model} at {flows} flows: {s.throughput:.1f} flow/s, "
            f"{s.latency_us:.1f} us a call (host {s.host_us:.1f} / device wait "
            f"{s.device_us:.1f}); classes equal the CPU's except {int(differ.sum())} of "
            f"{int(tie.sum())} near ties; launches a call "
            f"{ {k: v / FLOW_CALLS for k, v in counts.items() if v} } [{card}; the paper's "
            f"FPGA with collaborating: {PAPER_KFLOW_S} kflow/s]")
    errs = check_recorded(checks, shapes, "the paths")
    log(f"  [paths] {time.perf_counter() - t_phase:.1f} s")
    return errs


class HostCounters:
    """The two-level tracker's byte counters kept on the host, lane by lane,
    from the packets alone: each lane a hot table of ``table`` slots and a
    cold table of ``cold`` entries (two candidate slots a tuple, "age"
    stamps), fed its packets in batch order, a step as the pipeline runs
    it: promote, merge with spills, spill, scrub, drain (``top_n``, the
    lane's share of ``max_ready``, lowest slots first).  An entry keeps
    only what the ranking reads: [tuple, packets, bytes, last ts]."""

    def __init__(self, table: int, cold: int, lanes: int, max_ready: int, top_n: int):
        self.table, self.cold_size, self.top_n = table, cold, top_n
        self.lane_ready = max_ready // lanes
        self.hot = [{} for _ in range(lanes)]  # slot -> entry
        self.cold = [{} for _ in range(lanes)]  # cold slot -> entry + [stamp]

    def step(self, tuple_hash: list, size: list, ts: list) -> None:
        from repro_torch.core.flow_tracker import shard_of

        lanes = [[] for _ in self.hot]
        for pkt in zip(tuple_hash, size, ts):
            lanes[shard_of(pkt[0], len(self.hot))].append(pkt)
        for hot, cold, pkts in zip(self.hot, self.cold, lanes):
            self._lane_step(hot, cold, pkts)

    def _find(self, cold: dict, h: int):
        from repro_torch.core.cold_store import cold_slots_scalar

        return next((c for c in cold_slots_scalar(h, self.cold_size)
                     if c in cold and cold[c][0] == h), None)

    def _insert(self, cold: dict, entry: list) -> None:
        """The tuple's own slot, then an empty candidate (a first), then the
        smaller stamp (a on a tie)."""
        from repro_torch.core.cold_store import cold_slots_scalar

        a, b = cold_slots_scalar(entry[0], self.cold_size)
        ea, eb = cold.get(a), cold.get(b)
        if ea is not None and ea[0] == entry[0]:
            dst = a
        elif eb is not None and eb[0] == entry[0]:
            dst = b
        elif ea is None or eb is None:
            dst = a if ea is None else b
        else:
            dst = a if ea[4] <= eb[4] else b
        cold[dst] = [*entry[:4], entry[3]]  # "age": stamped with the last ts

    def _lane_step(self, hot: dict, cold: dict, pkts: list) -> None:
        from repro_torch.core.flow_tracker import hash_slot_scalar

        slot = lambda h: hash_slot_scalar(h, self.table)
        heads = {}
        for h, _, _ in pkts:
            heads.setdefault(slot(h), h)
        for s in sorted(heads):  # promote, ascending slot order
            h, occupant = heads[s], hot.get(s)
            src = None if occupant is not None and occupant[0] == h else self._find(cold, h)
            if src is not None:
                entry = cold.pop(src)
                if occupant is not None:
                    self._insert(cold, occupant)
                hot[s] = entry[:4]
        spills = []
        for h, size, t in pkts:  # merge, recording each evicted occupant
            s = slot(h)
            entry = hot.get(s)
            if entry is not None and entry[0] != h:
                spills.append(entry)
                entry = None
            if entry is None:
                entry = hot[s] = [h, 0, 0, 0]
            entry[1] += 1
            entry[2] += size
            entry[3] = t
        for entry in spills:
            self._insert(cold, entry)
        for h, _, _ in pkts:  # scrub: no tuple live in hot stays in cold
            entry = hot.get(slot(h))
            c = self._find(cold, h) if entry is not None and entry[0] == h else None
            if c is not None:
                del cold[c]
        for s in sorted(s for s, e in hot.items() if e[1] >= self.top_n)[:self.lane_ready]:
            del hot[s]

    def counters(self) -> dict[int, int]:
        return {e[0]: e[2] for level in (*self.hot, *self.cold) for e in level.values()}


def scenarios_phase(torch, kernels, record_routes, TrafficConfig, TrafficGenerator, mlp, cnn,
                    cnn_layers: list, card: str) -> None:
    """The three scenarios over the CNN f32 pipeline at ``PIPE``, card
    against CPU: the heavy hitter (single lane and 4 lanes, two-level)
    also against :class:`HostCounters`, launching no engine kernel; DDoS
    with the band from the probe's score quantiles; each attack mode."""
    import numpy as np

    from repro_torch.core import flow_tracker as ft
    from repro_torch.scenarios import (
        AdversarialScenario,
        DDoSScenario,
        HeavyHitterScenario,
        adversarial_config,
        flow_counters,
        top_k_flows,
    )
    from repro_torch.serving import OctopusPipeline, PipelineConfig

    t_phase = time.perf_counter()
    weights = dict(pkt_params=mlp, flow_params=cnn)
    log(f"[scenarios] CNN f32, {PIPE}: heavy hitter (k {HH_K}), DDoS, attack modes; card vs CPU")
    hh_batches = make_batches(TrafficConfig, TrafficGenerator, SPILL_TRAFFIC, HH_STEPS, "cpu")
    for lanes, cold in ((0, COLD_SIZE), (4, LANE_COLD)):
        label = f"heavy hitter, {max(lanes, 1)} lane{'s' if lanes else ''} x {cold} cold"
        kw = dict(k=HH_K, num_shards=lanes, cold_size=cold, **PIPE, **weights)
        gpu, cpu = HeavyHitterScenario(**kw, device=CARD), HeavyHitterScenario(**kw, device="cpu")
        host = HostCounters(PIPE["table_size"], cold, max(lanes, 1), PIPE["max_ready"],
                            gpu.cfg.top_n)
        gpu.pipe.warmup()
        sync(torch)
        kernels.reset_launches()
        snaps, top_s = [], 0.0
        for batch in hh_batches:
            gpu.step(ft.PacketBatch(*(a.to(CARD) for a in batch)))
            t0 = time.perf_counter()
            snaps.append(gpu.top_k())
            top_s += time.perf_counter() - t0
        counts = expect_launches(kernels, {"flow_update": HH_STEPS}, label)
        for step, batch in enumerate(hh_batches):
            cpu.step(batch)
            host.step(batch.tuple_hash.tolist(), batch.size.tolist(), batch.ts.tolist())
            want = host.counters()
            if cpu.counters() != want:
                raise AssertionError(f"{label} step {step}: the CPU's counters differ from the "
                                     "host's")
            if snaps[step] != cpu.top_k() or snaps[step] != top_k_flows(want, HH_K):
                raise AssertionError(f"{label} step {step}: top-k differs")
        same_tree(torch, f"{label} state", gpu.pipe.state, cpu.pipe.state)
        if flow_counters(gpu.pipe.state) != host.counters():
            raise AssertionError(f"{label}: the card's counters differ from the host's")
        s = gpu.pipe.stats
        log(f"  {label}: top-{HH_K} equal card, CPU and the host's counters every step over "
            f"{HH_STEPS} steps ({len(host.counters())} resident flows, spilled {s.spilled}, "
            f"promoted {s.promoted}, heaviest {snaps[-1][:2]}); step {s.step_us:.1f} us (host "
            f"{s.host_us:.1f} / device wait {s.device_us:.1f}), top-k read {top_s / HH_STEPS * 1e3:.2f} "
            f"ms; launches {counts_text(counts)} [{card}]")
        if s.spilled == 0 or s.promoted == 0:
            raise AssertionError(f"{label}: spilled {s.spilled}, promoted {s.promoted}")
        del gpu, cpu

    ddos_batches = make_batches(TrafficConfig, TrafficGenerator, DDOS_TRAFFIC, DDOS_STEPS, "cpu")
    card_batches = [ft.PacketBatch(*(a.to(CARD) for a in b)) for b in ddos_batches]
    probe = DDoSScenario(deny_on=0.99, deny_off=0.0, **PIPE, **weights, device=CARD)
    probe.pipe.warmup()
    with record_routes() as routes:
        probe.step(card_batches[0])
    if [(r.name, r.m, r.k, r.n) for r in routes] != cnn_layers:
        raise AssertionError(f"DDoS step matmuls {routes} are not the checked {cnn_layers}")
    probe.run(card_batches[1:], DDOS_STEPS - 1)
    scores = np.array([s for _, s in probe.emissions])
    if scores.size < 8:
        raise AssertionError(f"the DDoS probe emitted {scores.size} flows")
    on, off = (float(q) for q in np.quantile(scores, [0.6, 0.4]))
    gpu = DDoSScenario(deny_on=on, deny_off=off, **PIPE, **weights, device=CARD)
    cpu = DDoSScenario(deny_on=on, deny_off=off, **PIPE, **weights, device="cpu")
    gpu.pipe.warmup()
    sync(torch)
    kernels.reset_launches()
    for batch in card_batches:
        gpu.step(batch)
        if any(gpu.pipe.rules.lookup(f)["action"] != "deny" for f in gpu.denied):
            raise AssertionError("DDoS: a denied flow does not read deny after a dispatch")
    want = kernels.matmul_launches(routes, DDOS_STEPS)
    want["flow_update"] += DDOS_STEPS
    counts = expect_launches(kernels, want, "DDoS")
    for batch in ddos_batches:
        cpu.step(batch)
    if [f for f, _ in gpu.emissions] != [f for f, _ in cpu.emissions]:
        raise AssertionError("DDoS: the emitted flows differ card vs CPU")
    got, ref = (np.array([s for _, s in sc.emissions]) for sc in (gpu, cpu))
    err = float((np.abs(got - ref) / ref).max())
    if err > DDOS_SCORE_RTOL:
        raise AssertionError(f"DDoS: scores differ by {err} of the CPU's, card vs CPU")
    near = {f for f, s in cpu.emissions
            if min(abs(s - on) / on, abs(s - off) / off) <= DDOS_SCORE_RTOL}
    if not (gpu.denied ^ cpu.denied) <= near:
        raise AssertionError("DDoS: denied sets differ away from a near tie")
    s = gpu.pipe.stats
    log(f"  DDoS, band [{off:.6f}, {on:.6f}] from the probe's {scores.size} scores: "
        f"{len(gpu.emissions)} emissions, fids equal and scores within {err:.3e} of the CPU's; "
        f"denied {len(gpu.denied)} (CPU {len(cpu.denied)}, {len(near)} near ties), churn "
        f"{gpu.churn} <= raw {gpu.churn_raw}; each denied flow reads deny after every "
        f"dispatch; step {s.step_us:.1f} us (host {s.host_us:.1f} / device wait "
        f"{s.device_us:.1f}), probe step {probe.pipe.stats.step_us:.1f} us; launches "
        f"{counts_text(counts)} [{card}]")
    if gpu.churn > gpu.churn_raw or not gpu.denied:
        raise AssertionError(f"DDoS: denied {len(gpu.denied)}, churn {gpu.churn} over raw "
                             f"{gpu.churn_raw}")
    del probe, gpu, cpu

    for mode, kw in ADV_MODES.items():
        cfg = adversarial_config(mode, batch_size=PIPE["batch_size"],
                                 table_size=PIPE["table_size"], seed=3, **kw)
        gpu = AdversarialScenario(OctopusPipeline(mlp, cnn, PipelineConfig(**PIPE), device=CARD),
                                  cfg)
        cpu = AdversarialScenario(OctopusPipeline(mlp, cnn, PipelineConfig(**PIPE), device="cpu"),
                                  cfg)
        gpu.pipe.warmup()
        sync(torch)
        kernels.reset_launches()
        gs = gpu.run(ADV_STEPS)
        want = kernels.matmul_launches(routes, ADV_STEPS)
        want["flow_update"] += ADV_STEPS
        counts = expect_launches(kernels, want, mode)
        cs = cpu.run(ADV_STEPS)
        same_tree(torch, f"{mode} state", gpu.pipe.state, cpu.pipe.state)
        for name in ("packets", "flows", "new_flows", "evicted", "fallback_steps"):
            if getattr(gs, name) != getattr(cs, name):
                raise AssertionError(f"{mode}: stats.{name} differs card vs CPU")
        log(f"  {mode} ({kw}): step {gs.step_us:.1f} us (host {gs.host_us:.1f} / device wait "
            f"{gs.device_us:.1f}), new flows {gs.new_flows}, evicted {gs.evicted}, drained "
            f"{gs.flows}, fallback steps {gs.fallback_steps} over {ADV_STEPS} steps; tracker "
            f"state and counters equal the CPU's; launches {counts_text(counts)} [{card}]")
    log(f"  [scenarios] {time.perf_counter() - t_phase:.1f} s")


def calibrate_phase(torch, ft, fx, kernels, record_routes, checks, TrafficConfig,
                    TrafficGenerator, OctopusPipeline, PipelineConfig, mlp, cnn, batches,
                    cnn_layers) -> tuple[dict, dict]:
    """``[calibrate]``: ``autotune.calibrate`` on the card over the 64-point
    grid, twice (each shape's times, both fits, and what the fit reads at
    M = 8, where both arms launch the same skinny kernel), and the grid's
    device time fitted the same way beside them; the first sweep's
    artifact saved and loaded through ``RuntimeConfig.calibrated``, its
    divergence report at ``CALIB_FLOWS``; the CNN pipeline under that config
    for the pipeline phase's steps with launch counts as ``record_routes``
    predicts under the calibrated placements, every routed matmul's shape
    against its plain version, and card vs CPU (tracker state, drained rows
    and decisions bit for bit; both engines' logits within rtol 1e-5 on the
    CPU's inputs); then the CLI's smoke run in a subprocess (exit 0).
    Returns (each kernel's largest error at the recorded shapes, the
    pipeline's launch counts)."""
    import os
    import tempfile

    from repro_torch.core import router
    from repro_torch.launch.calibrate import divergence_report
    from repro_torch.runtime import RoutePlan, RuntimeConfig, autotune

    sweeps = []
    for i in range(CALIB_SWEEPS):
        t0 = time.perf_counter()
        calib = autotune.calibrate(iters=CALIB_ITERS, device=CARD)
        sweeps.append(calib)
        log(f"[calibrate] sweep {i + 1} on {calib.fingerprint_id}: {len(calib.timings)} (m,k,n) "
            f"shapes x 2 arms, the median of {CALIB_ITERS} synchronised calls each, "
            f"{time.perf_counter() - t0:.2f} s; vpe won "
            f"{sum(t.vpe_wins for t in calib.timings)}/{len(calib.timings)}; fit tau "
            f"{calib.tau:.6f}, vpe_max_elems {calib.vpe_max_elems}")
        for t in calib.timings:
            log(f"  ({t.m},{t.k},{t.n}) util {t.util:.4f}: arype {t.us_arype:.2f} us, vpe "
                f"{t.us_vpe:.2f} us ({t.us_vpe / t.us_arype:.3f}x)"
                f"{'  vpe wins' if t.vpe_wins else ''}")
    for i, calib in enumerate(sweeps):
        skinny = [t for t in calib.timings if t.m <= 8]
        ratios = [t.us_vpe / t.us_arype for t in skinny]
        tau, cap = autotune.fit_crossover([t for t in calib.timings if t.m > 8])
        log(f"  sweep {i + 1} at M = 8, where both arms launch mm_fused's skinny split-K (the "
            f"same bits): vpe won {sum(t.vpe_wins for t in skinny)}/{len(skinny)}, vpe/arype "
            f"{min(ratios):.3f}-{max(ratios):.3f}; the fit without those shapes: tau "
            f"{tau:.6f}, vpe_max_elems {cap}")
    log(f"  the two sweeps' fits: tau {sweeps[0].tau:.6f} / {sweeps[1].tau:.6f}, vpe_max_elems "
        f"{sweeps[0].vpe_max_elems} / {sweeps[1].vpe_max_elems}")
    # The sweep times a synchronised call, as the reference does: at these
    # shapes that is mostly the host's dispatch.  The same grid's device
    # time (CUDA events behind a sleep, time_ms) fitted the same way, beside.
    device_timings = []
    for t in sweeps[0].timings:
        x = torch.randn(t.m, t.k, generator=torch.Generator().manual_seed(0)).to(CARD)
        w = torch.randn(t.k, t.n, generator=torch.Generator().manual_seed(1)).to(CARD)
        us = {p: 1e3 * time_ms(lambda c=RuntimeConfig(policy=p): router.matmul(x, w, config=c))
              for p in ("arype_only", "vpe_only")}
        device_timings.append(autotune.ShapeTiming(t.m, t.k, t.n, t.util, us["arype_only"],
                                                   us["vpe_only"]))
    tau, cap = autotune.fit_crossover(device_timings)
    device_fit = RuntimeConfig(tau=tau, vpe_max_elems=cap, calibration="device time")
    log(f"[calibrate] the same grid's device time a call (CUDA events, {len(device_timings)} "
        f"shapes): vpe won {sum(t.vpe_wins for t in device_timings)}/{len(device_timings)}; "
        f"fit tau {device_fit.tau:.6f}, vpe_max_elems {device_fit.vpe_max_elems}")
    for t in device_timings:
        log(f"  ({t.m},{t.k},{t.n}) util {t.util:.4f}: arype {t.us_arype:.3f} us, vpe "
            f"{t.us_vpe:.3f} us ({t.us_vpe / t.us_arype:.3f}x){'  vpe wins' if t.vpe_wins else ''}")
    with tempfile.TemporaryDirectory() as tmp:
        path = autotune.save_calibration(sweeps[0], os.path.join(tmp, "calib.json"))
        cfg = RuntimeConfig.calibrated(path, device=CARD)
        if (cfg.tau, cfg.vpe_max_elems, cfg.calibration) != (
                sweeps[0].tau, sweeps[0].vpe_max_elems, sweeps[0].fingerprint_id):
            raise AssertionError(f"RuntimeConfig.calibrated read {cfg} from the artifact")
        log(f"[calibrate] sweep 1's artifact through RuntimeConfig.calibrated: tau {cfg.tau}, "
            f"vpe_max_elems {cfg.vpe_max_elems}, calibration {cfg.calibration!r}")
        fitted = [(f"sweep {i + 1}", calib.apply()) for i, calib in enumerate(sweeps)]
        for label, fit in fitted + [("the device-time fit", device_fit)]:
            log(f"[calibrate] placement divergence at {TABLE6_FLOWS} flows, {label} (analytic "
                "-> calibrated):")
            log("  " + divergence_report(fit, flows=TABLE6_FLOWS).replace("\n", "\n  "))

        plan = RoutePlan.from_layers(cnn_layers, config=cfg)
        expected = plan.engines()
        moved = {n: f"{CNN_PLACEMENT[n]} -> {e}" for n, e in expected.items()
                 if e != CNN_PLACEMENT[n]}
        log(f"[pipeline] f32 under the calibrated config, 8k table, batch 1024, 256 drained "
            f"flows/step, CNN, {len(batches)} steps; moved from the analytic placement: "
            f"{moved or 'none'}")
        pipe = OctopusPipeline(mlp, cnn, PipelineConfig(**PIPE), config=cfg)
        counts, _ = drive_pipeline(kernels, record_routes, pipe, batches, cnn_layers, expected,
                                   quantized=False)
        text = pipe.explain()
        if f"[calibrated: {cfg.calibration}]" not in text:
            raise AssertionError(f"the plan does not name its calibration:\n{text}")
        log(text)
        pipe.reset()
        with record_routes() as routes:
            pipe.step(batches[0])
        shapes: dict = {}
        note_shapes(kernels, routes, "calibrated", shapes)
        errs = check_recorded(checks, shapes, "the calibrated pipeline")
        log(f"[card vs cpu] f32 under the calibrated config, ordinary traffic, "
            f"{CALIB_CPU_STEPS} steps")
        cpu_batches = make_batches(TrafficConfig, TrafficGenerator, TRAFFIC, CALIB_CPU_STEPS,
                                   "cpu")
        pipes = (OctopusPipeline(mlp, cnn, PipelineConfig(**PIPE), config=cfg),
                 OctopusPipeline(mlp, cnn, PipelineConfig(**PIPE), config=cfg, device="cpu"))
        res = compare_runs(torch, ft, fx, pipes, cpu_batches, "calibrated",
                           logit_rtol=MATMUL_RTOL)
        if res["flipped"]:
            raise AssertionError(f"calibrated: {res['flipped']} decisions differ card vs CPU")
        log(f"  tracker state, drained rows and decisions bit-identical over {CALIB_CPU_STEPS} "
            f"steps ({pipes[1].stats.flows} flows drained, {res['near']} near ties, none "
            f"flipped); packet and flow logits on the CPU's inputs within rtol {MATMUL_RTOL}, "
            f"largest difference {res['max_rel']:.3e} of max|logit|")
        if pipes[1].stats.flows == 0:
            raise AssertionError("calibrated: no flow drained")

        src = str(ROOT / "src")
        env = dict(os.environ, OCTOPUS_CACHE_DIR=tmp,
                   PYTHONPATH=os.pathsep.join(filter(None, (src, os.environ.get("PYTHONPATH")))))
        cmd = [sys.executable, "-m", "repro_torch.launch.calibrate", "--smoke", "--out",
               os.path.join(tmp, "cli.json")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=str(ROOT),
                              timeout=CALIB_CLI_TIMEOUT)
        log(f"[calibrate] python -m repro_torch.launch.calibrate --smoke --out <tmp>: exit "
            f"{proc.returncode} in {time.perf_counter() - t0:.2f} s")
        for line in proc.stdout.splitlines():
            log("  | " + line)
        if proc.returncode != 0:
            raise AssertionError(f"the calibrate CLI exited {proc.returncode}:\n"
                                 f"{proc.stderr[-4000:]}")
    return errs, counts


def moe_route_ties(torch, layers, cfg, captured: list) -> None:
    """Expert ids card against CPU on the CPU run's own MoE layer inputs
    (``captured``: (ln, router, x) a layer call): each group of tokens
    normed and routed on both devices.  A row's ordered top-k ids may differ
    only where the CPU's logits at the first differing position and the next
    are closer than ``MOE_TIE_GAP`` (read as the log of the CPU's
    probabilities' ratio, which is that logit gap); such rows are counted,
    beside every row with so close a gap within its top k + 1."""
    k = cfg.experts_per_token
    rows = near = flipped = 0
    worst = 0.0
    for ln, router_w, x in captured:
        b, s, d = x.shape
        g = b if s > 1 else max(1, min(b, 8))
        p_c, _, ids_c = layers.moe_route(router_w, layers.rms_norm(x, ln).reshape(g, -1, d), k)
        p_g, _, ids_g = layers.moe_route(router_w.to(CARD),
                                         layers.rms_norm(x.to(CARD), ln.to(CARD)).reshape(g, -1, d),
                                         k)
        p_g, ids_g = p_g.cpu(), ids_g.cpu()
        worst = max(worst, (p_g.log() - p_c.log()).abs().max().item())
        top = torch.sort(p_c, dim=-1, descending=True, stable=True).values[..., :k + 1].log()
        gaps = top[..., :-1] - top[..., 1:]  # (G, T, k): logit gaps down the CPU's order
        near += int((gaps < MOE_TIE_GAP).any(dim=-1).sum())
        rows += ids_c.shape[0] * ids_c.shape[1]
        differ = (ids_g != ids_c)
        for gi, ti in differ.any(dim=-1).nonzero().tolist():
            j = int(differ[gi, ti].nonzero()[0])
            if gaps[gi, ti, j].item() >= MOE_TIE_GAP:
                raise AssertionError(f"expert ids differ card vs CPU at a logit gap of "
                                     f"{gaps[gi, ti, j].item():.3e}: card {ids_g[gi, ti].tolist()}, "
                                     f"cpu {ids_c[gi, ti].tolist()}")
            flipped += 1
    log(f"  expert routing on the CPU run's {len(captured)} MoE layer inputs ({rows} token rows): "
        f"top-{k} ids equal card vs CPU except {flipped} rows, each at a near tie; {near} rows "
        f"have a logit gap under {MOE_TIE_GAP} within their top {k + 1}; largest router "
        f"log-probability difference {worst:.3e}")


def check_recorded_mixed(torch, cfg, shapes, engines, gen, *, time_it: bool = True,
                         w_dtype=None) -> dict:
    """Each engine's bf16-x arm at every matmul shape a run recorded
    (``shapes``: kernel -> {(m, k, n): name}; ``engines``: kernel ->
    (wrapper, plain twin, plan)), through ``check_mixed_matmuls`` on w of
    ``w_dtype`` (f32 by default: the mixed arm).  Returns each kernel's
    record: its largest error from its twin and, with ``time_it``, its times
    summed over the shapes (one call each)."""
    recs = {}
    names = {(k, n): name for name, k, n in lm_forward_matmuls(cfg)}  # the unnamed projections
    arm = "bf16-weight arm (bf16 x, bf16 w)" if w_dtype == torch.bfloat16 else \
        "mixed arm (bf16 x, f32 w)"
    for kernel, seen in sorted(shapes.items()):
        engine, plain, plan = engines[kernel]
        todo = [("lm_head" if n == cfg.padded_vocab else names.get((k, n), name), m, k, n)
                for (m, k, n), name in seen.items()]
        log(f"  {kernel}'s {arm} at the {len(todo)} shapes the runs launched it at, against "
            "its plain version:")
        recs[kernel] = check_mixed_matmuls(torch, engine, plain, todo, gen, plan=plan,
                                           time_it=time_it, w_dtype=w_dtype)
        if not time_it:
            log(f"    bit for bit the f32 arm on x.float(); worst error from the twin "
                f"{recs[kernel]['max_abs_err']:.3e}")
    return recs


def check_prefill_flash(torch, fa, gen, cfg, slots: int, prompts) -> float:
    """``flash_fwd`` in bf16 against its plain twin at a serve's prefill
    shapes: B ``slots`` and 1, each prompt length, causal.  Returns the
    largest error."""
    log(f"  flash_fwd in bf16 at the prefill shapes ({cfg.num_heads} heads over "
        f"{cfg.num_kv_heads}, D {cfg.head_dim}, causal; the serve's B {slots} and the batch-1 "
        "runs'):")
    worst = 0.0
    for b in (slots, 1):
        for n in prompts:
            case = (b, cfg.num_heads, cfg.num_kv_heads, n, n, cfg.head_dim, "causal", 0, None)
            worst = max(worst, flash_case(torch, fa, gen, case, "bfloat16",
                                          lm_layout=True)["max_abs_err"])
    return worst


def granite_phase(torch, np, kernels, record_routes, lm_mod, layers, serving, get_config, fa,
                  arype, vpe_matmul, vpe_mm, gen) -> dict:
    """``[lm granite-moe-1b-a400m]``: granite at full width and depth as
    registered (bf16 compute on f32 weights) serving ``GRANITE_PROMPTS``
    through ``ServeEngine`` (tokens equal each request served alone at the
    same slots, and its batch-1 greedy run except counted near ties under
    ``BF16_TIE_GAP``; launches as predicted); then ``mm_fused``'s and
    ``vpe_mm``'s mixed arms at every matmul shape the serve and the batch-1
    runs recorded, and ``flash_fwd`` in bf16 at the prefill shapes of both
    (B 4 and 1, 16 heads over 8, D 64, causal), against their plain
    versions; then one request in f32 compute card vs CPU at full depth
    (``lm_card_vs_cpu``) with the expert ids held to the CPU's on the same
    layer inputs (``moe_route_ties``).  Returns each kernel's largest error."""
    cfg = get_config(GRANITE_ARCH)
    t0 = time.perf_counter()
    params = lm_mod.LM(cfg, device=CARD).init(torch.Generator(device=CARD).manual_seed(0))
    torch.cuda.synchronize()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in GRANITE_PROMPTS]
    log(f"[lm {GRANITE_ARCH}] as registered (compute {cfg.compute_dtype}, params "
        f"{cfg.param_dtype}), d_model {cfg.d_model}, {cfg.num_heads} heads over "
        f"{cfg.num_kv_heads}, head_dim {cfg.head_dim}, {cfg.num_experts} experts of "
        f"{cfg.moe_d_ff} top {cfg.experts_per_token}, vocab {cfg.vocab_size} (padded "
        f"{cfg.padded_vocab}), {cfg.num_layers} layers, "
        f"{sum(t.numel() for t in _leaves(params))} parameters (seed 0) in "
        f"{time.perf_counter() - t0:.2f} s; ServeConfig({GRANITE_SERVE}), prompts "
        f"{list(GRANITE_PROMPTS)}, max_new {GRANITE_MAX_NEW}; near ties under {BF16_TIE_GAP} "
        "counted")
    shapes: dict = {}
    serve_lm(torch, kernels, record_routes, lm_mod, serving, cfg, params, prompts,
             serve=GRANITE_SERVE, max_new=GRANITE_MAX_NEW, near_tie=BF16_TIE_GAP, alone=True,
             shapes=shapes)
    engines = {"mm_fused": (arype.arype_matmul, arype.mm_fused, arype.card_plan),
               "vpe_mm": (vpe_matmul, vpe_mm, None)}
    errs = {k: r["max_abs_err"] for k, r in
            check_recorded_mixed(torch, cfg, shapes, engines, gen).items()}
    errs["flash_fwd"] = check_prefill_flash(torch, fa, gen, cfg, GRANITE_SERVE["batch_slots"],
                                            GRANITE_PROMPTS)

    f32 = cfg.replace(compute_dtype="float32")
    log(f"[lm {GRANITE_ARCH} card vs cpu] f32 compute, batch 1, a {LM_CPU_PROMPT}-token "
        f"prompt, prefill + {LM_CPU_DECODES} decode steps at full depth")
    captured = []
    moe_apply = lm_mod.moe_apply

    def spy(p, x, c, num_groups=None):
        if x.device.type == "cpu":
            captured.append((p["ln"], p["router"], x))
        return moe_apply(p, x, c, num_groups)

    lm_mod.moe_apply = spy
    try:
        lm_card_vs_cpu(torch, lm_mod, f32, params, rng)
    finally:
        lm_mod.moe_apply = moe_apply
    if not captured:
        raise AssertionError("the CPU run went through no MoE layer")
    moe_route_ties(torch, layers, cfg, captured)
    del params, captured
    torch.cuda.empty_cache()
    return errs


def check_quant_bf16(torch, engine, plain, shapes, g) -> None:
    """An int8 engine on bf16 x (w f32 and bf16) into bf16 at each (name, m,
    k, n), with a per-tensor and a per-channel weight scale, under none and
    relu: bit for bit with its plain twin on the card (each element quantized
    as its exact f32, the int32 sums exact, one rounding of the same f32
    value), and with the kernel's own f32 output rounded once.  Times the
    kernel beside the twin at the per-channel scales on bf16 w, with the
    bound of 2-byte operands and output (or 2MKN int8 operations).  Raises
    on any output that differs."""
    from repro_torch.runtime.quant import pick_scale

    t = tp = 0.0
    nbytes = ops = 0
    for name, m, k, n in shapes:
        x = (torch.randn(m, k, generator=g, device=CARD) * 3).to(torch.bfloat16)
        sx = pick_scale(x.float().abs().max().item())
        for wt in (torch.float32, torch.bfloat16):
            w = torch.randn(k, n, generator=g, device=CARD).to(wt)
            for sw in (pick_scale(w.float().abs().max().item()),
                       tuple(pick_scale(v) for v in w.float().abs().amax(0).tolist())):
                for act in ("none", "relu"):
                    kw = dict(scale_x=sx, scale_w=sw, activation=act)
                    out = engine(x, w, **kw)
                    if out.dtype != torch.bfloat16 or not torch.equal(out, plain(x, w, **kw)):
                        raise AssertionError(f"{engine.__name__} bf16 x {name} w {wt} {act}: "
                                             "differs from its plain twin")
                    if not torch.equal(out, engine(x, w, out_dtype=torch.float32, **kw)
                                       .to(torch.bfloat16)):
                        raise AssertionError(f"{engine.__name__} bf16 x {name} w {wt} {act}: "
                                             "not its f32 output rounded once")
        t += time_ms(lambda: engine(x, w, scale_x=sx, scale_w=sw))
        tp += time_ms(lambda: plain(x, w, scale_x=sx, scale_w=sw))
        nbytes, ops = nbytes + 2 * (m * k + k * n + m * n), ops + 2 * m * k * n
    b, by = bound(nbytes, ops, INT8_OPS_PER_S)
    log(f"  {engine.__name__} on bf16 x into bf16 at {[s[0] for s in shapes]}: bit for bit with "
        f"its plain twin (w f32 and bf16, per tensor and per channel, none and relu); per step "
        f"(bf16 w) kernel {t:.5f} ms, plain {tp:.5f} ms, bound {b:.6f} ms ({by})")


def _stack_head(tree, depth: int):
    """A stacked parameter tree cut to its first ``depth`` superblocks (views)."""
    if isinstance(tree, dict):
        return {k: _stack_head(v, depth) for k, v in tree.items()}
    return tree[:depth]


def starcoder_phase(torch, np, kernels, record_routes, lm_mod, serving, get_config,
                    reduced_config, fa, arype, vpe_matmul, vpe_mm, vpe_matmul_q, vpe_mm_q,
                    gen) -> dict:
    """``[lm starcoder2-15b]``: starcoder2-15b at full width and depth as
    registered (bf16 weights and compute, 31.9 GB, the peak of the seeded
    init logged) serving ``STAR_PROMPTS`` through ``ServeEngine`` (tokens
    equal each request served alone at the same slots, and its batch-1
    greedy run except counted near ties under ``BF16_TIE_GAP``; launches as
    predicted: 241 ``mm_fused`` a forward, 40 ``flash_fwd`` a prefill); then
    ``mm_fused``'s bf16-weight arm at every matmul shape the serve and the
    batch-1 runs recorded (``check_mixed_matmuls`` on bf16 w), timed per decode and
    per longest-prefill forward; the cold decode forward on the served
    weights; ``flash_fwd`` in bf16 at the prefill shapes (48 heads over 4,
    D 128, causal); the card against the CPU at full width with the depth
    cut to ``STAR_CPU_SUPERBLOCKS``, in f32 compute (the f32-x-on-bf16-w
    arm) within ``LM_LOGIT_TOL`` and in bf16 compute within
    ``BF16_LOGIT_TOL``; ``vpe_mm``'s bf16-weight arm at M 1-8 on the served
    weights (timed at ``VPE_SERVED_TIMED``) and at the VPE shapes of reduced starcoder2's batch-1 runs on
    the card; the int8 pair on bf16 x at the pipelines' shapes.  Returns the
    records of the two bf16-weight arms and each kernel's largest error."""
    cfg = get_config(STAR_ARCH)
    bf16 = torch.bfloat16
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm_mod.LM(cfg, device=CARD).init(torch.Generator(device=CARD).manual_seed(0))
    torch.cuda.synchronize()
    held = sum(t.numel() * t.element_size() for t in _leaves(params))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in STAR_PROMPTS]
    log(f"[lm {STAR_ARCH}] as registered (compute {cfg.compute_dtype}, params "
        f"{cfg.param_dtype}), d_model {cfg.d_model}, {cfg.num_heads} heads over "
        f"{cfg.num_kv_heads}, head_dim {cfg.head_dim}, gelu MLP {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.num_layers} layers, {sum(t.numel() for t in _leaves(params))} "
        f"parameters (seed 0, {held / 1e9:.3f} GB) in {time.perf_counter() - t0:.2f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB allocated while drawing; "
        f"ServeConfig({STAR_SERVE}), prompts {list(STAR_PROMPTS)}, max_new {STAR_MAX_NEW}; near "
        f"ties under {BF16_TIE_GAP} counted")
    shapes: dict = {}
    counts, _, _, _ = serve_lm(torch, kernels, record_routes, lm_mod, serving, cfg, params,
                               prompts, serve=STAR_SERVE, max_new=STAR_MAX_NEW,
                               near_tie=BF16_TIE_GAP, alone=True, shapes=shapes)
    if set(shapes) != {"mm_fused"}:
        raise AssertionError(f"starcoder2 launched {sorted(shapes)}: every matmul is past the "
                             "VPE's cap, so mm_fused alone")
    g = torch.Generator(device=CARD).manual_seed(2)
    todo = [("lm_head" if n == cfg.padded_vocab else name, m, k, n)
            for (m, k, n), name in shapes["mm_fused"].items()]
    log(f"  mm_fused's bf16-weight arm (bf16 x, bf16 w) at the {len(todo)} shapes the serve and "
        "the batch-1 runs launched it at: bit for bit the f32 arm on x.float(), w.float(), "
        "within one bf16 step of the plain twin")
    bf16w = dict(w_dtype=bf16, plan=arype.card_plan)
    errs = {"mm_fused": check_mixed_matmuls(torch, arype.arype_matmul, arype.mm_fused, todo, g,
                                            time_it=False, **bf16w)["max_abs_err"]}
    slots, longest = STAR_SERVE["batch_slots"], max(STAR_PROMPTS)
    rec = dict(max_abs_err=errs["mm_fused"], ms=0.0, plain_ms=0.0, library_ms=0.0,
               bound_ms=0.0, bytes=0, flops=0, ops_ms=0.0)
    for label, rows in (("decode", slots), (f"prefill of {longest} tokens", slots * longest)):
        *layer, head = lm_matmul_shapes(cfg, rows)
        log(f"[kernels] mm_fused bf16 x, bf16 w at the {STAR_ARCH} {label} shapes (L2-hot)")
        a, b = (check_mixed_matmuls(torch, arype.arype_matmul, arype.mm_fused, sh, g, **bf16w)
                for sh in (layer, [head]))
        per = {key: cfg.num_layers * a[key] + b[key]
               for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes", "flops",
                           "ops_ms")}
        log(f"  per {label} forward ({cfg.num_layers} layers + lm head, L2-hot): kernel "
            f"{per['ms']:.4f} ms, torch.matmul {per['library_ms']:.4f} ms "
            f"({per['ms'] / per['library_ms']:.2f}x), plain {per['plain_ms']:.4f} ms, bound "
            f"{per['bound_ms']:.4f} ms")
        for key, v in per.items():
            rec[key] += v
    rec["bound_by"] = "bytes" if rec["bytes"] / HBM_BYTES_PER_S * 1e3 >= rec.pop("ops_ms") \
        else "operations"
    rec["launches"] = counts["mm_fused"]
    # the decode forward cold, on the served weights themselves (no second copy)
    *layer, head = lm_matmul_shapes(cfg, slots)
    xs = {k: torch.randn(slots, k, generator=g, device=CARD).to(bf16)
          for _, _, k, _ in layer + [head]}
    names = {"wq": ("mixer", "wq"), "wk": ("mixer", "wk"), "wv": ("mixer", "wv"),
             "wo": ("mixer", "wo"), "wi_up": ("ffn", "wi_up"), "wo_mlp": ("ffn", "wo")}
    blocks = params["blocks"]["l0"]
    calls = [(xs[k], blocks[names[name][0]][names[name][1]][sb], bf16)
             for sb in range(cfg.num_superblocks) for name, _, k, _ in layer]
    calls.append((xs[head[2]], params["lm_head"], torch.float32))
    time_cold_forward(torch, arype, calls, "bf16 x, bf16 w (the served weights)", cfg.num_layers)
    del calls, xs
    errs["flash_fwd"] = check_prefill_flash(torch, fa, gen, cfg, slots, STAR_PROMPTS)

    cut = cfg.replace(num_superblocks=STAR_CPU_SUPERBLOCKS)
    cut_params = dict(params, blocks=_stack_head(params["blocks"], STAR_CPU_SUPERBLOCKS))
    f32 = cut.replace(compute_dtype="float32")
    log(f"[lm {STAR_ARCH} card vs cpu] full width, {STAR_CPU_SUPERBLOCKS} of "
        f"{cfg.num_superblocks} superblocks, bf16 weights in f32 compute (the f32 x on bf16 w "
        f"arm), batch 1, a {LM_CPU_PROMPT}-token prompt, prefill + {LM_CPU_DECODES} decode steps")
    lm_card_vs_cpu(torch, lm_mod, f32, cut_params, rng)
    log(f"[lm {STAR_ARCH} bf16 card vs cpu] the same in bf16 compute, with the request in "
        f"{LM_SERVE['batch_slots']} slots and the f32-compute control")
    lm_card_vs_cpu(torch, lm_mod, cut, cut_params, rng, tol=BF16_LOGIT_TOL, tie=BF16_TIE_GAP,
                   control_cfg=f32)

    log(f"[kernels] vpe_mm's bf16-weight arm at M 1-8 on {STAR_ARCH}'s served weights (layer 0 "
        "and the head): every activation, equal to arype_matmul and to the f32 arm")
    weights = [(name, blocks[part][leaf][0]) for name, (part, leaf) in names.items()]
    served = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms", "bytes", "ops_ms"), 0.0)
    for name, w in weights + [("lm_head", params["lm_head"])]:
        x8 = torch.randn(8, w.shape[0], generator=g, device=CARD).to(bf16)
        od = torch.float32 if name == "lm_head" else bf16
        for m in range(1, 9):
            x = x8[:m]
            for act in ACTS:
                got = vpe_matmul(x, w, activation=act)
                if not (torch.equal(got, arype.arype_matmul(x, w, activation=act)) and torch.equal(
                        got, vpe_matmul(x.float(), w.float(), activation=act).to(bf16))):
                    raise AssertionError(f"vpe_mm bf16 w {name} M {m} {act}: differs from "
                                         "arype_matmul or the f32 arm")
            if m not in VPE_SERVED_TIMED:
                continue
            k, n = w.shape
            nbytes = 2 * (m * k + k * n) + (4 if od == torch.float32 else 2) * m * n
            b, _ = bound(nbytes, 2 * m * k * n, BF16_OPS_PER_S)
            for key, v in (("ms", time_ms(lambda: vpe_matmul(x, w, out_dtype=od))),
                           ("plain_ms", time_ms(lambda: vpe_mm(x, w, out_dtype=od), calls=5)),
                           ("library_ms", time_ms(lambda: torch.matmul(x, w).to(od))),
                           ("bound_ms", b), ("bytes", nbytes),
                           ("ops_ms", 2 * m * k * n / BF16_OPS_PER_S * 1e3)):
                served[key] += v
    served["bound_by"] = ("bytes" if served["bytes"] / HBM_BYTES_PER_S * 1e3 >= served["ops_ms"]
                          else "operations")
    log(f"  timed at M {list(VPE_SERVED_TIMED)} on the 7 weights ({len(VPE_SERVED_TIMED) * 7} "
        f"shapes, L2-hot), summed: "
        f"kernel {served['ms']:.5f} ms, torch.matmul {served['library_ms']:.5f} ms "
        f"({served['ms'] / served['library_ms']:.2f}x), plain {served['plain_ms']:.5f} ms, bound "
        f"{served['bound_ms']:.6f} ms ({served['bound_by']})")
    del params, cut_params, blocks, weights
    torch.cuda.empty_cache()

    small = reduced_config(cfg).replace(param_dtype="bfloat16", compute_dtype="bfloat16",
                                        router_policy="collaborative")
    p_small = lm_mod.LM(small, device=CARD).init(torch.Generator(device=CARD).manual_seed(1))
    kernels.reset_launches()
    with record_routes() as routes:
        for n in (20, 37):
            greedy_single(torch, lm_mod.LM(small, device=CARD), p_small,
                          rng.integers(0, small.vocab_size, n), 8, 64)
    small_counts = kernels.launches()
    want = kernels.matmul_launches(routes)
    want["flash_fwd"] = 2 * small.num_layers
    if small_counts != want or not small_counts["vpe_mm"]:
        raise AssertionError(f"reduced {STAR_ARCH} batch-1 runs launched {small_counts}, "
                             f"recorded {want}")
    small_shapes: dict = {}
    note_shapes(kernels, routes, "reduced batch 1", small_shapes)
    log(f"[kernels] vpe_mm's bf16-weight arm at the {len(small_shapes['vpe_mm'])} VPE shapes of "
        f"reduced {STAR_ARCH}'s batch-1 runs on the card (launches {small_counts}; its "
        f"{len(small_shapes['mm_fused'])} mm_fused shapes checked too)")
    small_todo = {kernel: [("lm_head" if n == small.padded_vocab else name, m, k, n)
                           for (m, k, n), name in seen.items()]
                  for kernel, seen in small_shapes.items()}
    vrec = check_mixed_matmuls(torch, vpe_matmul, vpe_mm, small_todo["vpe_mm"], g, w_dtype=bf16,
                               same_as=arype.arype_matmul)
    del vrec["ops_ms"]
    vrec["launches"] = small_counts["vpe_mm"]
    # beside the reduced model's toy shapes, the served weights' decode sizes
    vrec.update({f"served_{key}": served[key]
                 for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
    errs["mm_fused"] = max(errs["mm_fused"], check_mixed_matmuls(
        torch, arype.arype_matmul, arype.mm_fused, small_todo["mm_fused"], g, time_it=False,
        **bf16w)["max_abs_err"])
    del p_small

    log("[kernels] the int8 pair on bf16 x into bf16 at the pipelines' shapes")
    check_quant_bf16(torch, vpe_matmul_q, vpe_mm_q, VPE_SHAPES, g)
    check_quant_bf16(torch, arype.arype_matmul_q, arype.mm_fused_q,
                     ARYPE_SHAPES + TF_ARYPE_SHAPES, g)
    torch.cuda.empty_cache()
    return {"mm_fused": rec, "vpe_mm": vrec, "errs": errs}


def qwen4b_phase(torch, np, kernels, record_routes, lm_mod, serving, get_config, fa, arype,
                 vpe_matmul, vpe_mm, gen) -> dict:
    """``[lm qwen3-4b]``: qwen3-4b at full width and depth as registered
    (f32 weights, bf16 compute, 17.6 GB) serving ``QWEN4_PROMPTS`` at
    ``LM_SERVE``: tokens equal each request served alone, and its batch-1
    greedy run except counted near ties under ``BF16_TIE_GAP``; launches as
    predicted (253 ``mm_fused`` a forward, 36 ``flash_fwd`` a prefill); then
    the engines' mixed arm (bf16 x, f32 w) at every matmul shape the serve
    and the batch-1 runs recorded, and ``flash_fwd`` in bf16 at the prefill
    shapes of both (32 heads over 8, D 128, causal), against their plain
    versions; then the card against the CPU at full width with the depth
    cut to ``QWEN4_CPU_SUPERBLOCKS``, in f32 compute within
    ``LM_LOGIT_TOL`` and in bf16 compute within ``BF16_LOGIT_TOL``.  Returns
    each kernel's largest error."""
    cfg = get_config(QWEN4_ARCH)
    t0 = time.perf_counter()
    params = lm_mod.LM(cfg, device=CARD).init(torch.Generator(device=CARD).manual_seed(0))
    torch.cuda.synchronize()
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in QWEN4_PROMPTS]
    log(f"[lm {QWEN4_ARCH}] as registered (compute {cfg.compute_dtype}, params "
        f"{cfg.param_dtype}), d_model {cfg.d_model}, {cfg.num_heads} heads over "
        f"{cfg.num_kv_heads}, d_ff {cfg.d_ff}, {cfg.num_layers} layers, "
        f"{sum(t.numel() for t in _leaves(params))} parameters (seed 0) in "
        f"{time.perf_counter() - t0:.2f} s; ServeConfig({LM_SERVE}), prompts "
        f"{list(QWEN4_PROMPTS)}, max_new {QWEN4_MAX_NEW}; near ties under {BF16_TIE_GAP} counted")
    shapes: dict = {}
    serve_lm(torch, kernels, record_routes, lm_mod, serving, cfg, params, prompts,
             max_new=QWEN4_MAX_NEW, near_tie=BF16_TIE_GAP, alone=True, shapes=shapes)
    engines = {"mm_fused": (arype.arype_matmul, arype.mm_fused, arype.card_plan),
               "vpe_mm": (vpe_matmul, vpe_mm, None)}
    errs = {k: r["max_abs_err"] for k, r in
            check_recorded_mixed(torch, cfg, shapes, engines, gen, time_it=False).items()}
    errs["flash_fwd"] = check_prefill_flash(torch, fa, gen, cfg, LM_SERVE["batch_slots"],
                                            QWEN4_PROMPTS)

    cut = cfg.replace(num_superblocks=QWEN4_CPU_SUPERBLOCKS)
    cut_params = dict(params, blocks=_stack_head(params["blocks"], QWEN4_CPU_SUPERBLOCKS))
    f32 = cut.replace(compute_dtype="float32")
    log(f"[lm {QWEN4_ARCH} card vs cpu] full width, {QWEN4_CPU_SUPERBLOCKS} of "
        f"{cfg.num_superblocks} superblocks, f32 compute, batch 1, a {LM_CPU_PROMPT}-token "
        f"prompt, prefill + {LM_CPU_DECODES} decode steps")
    lm_card_vs_cpu(torch, lm_mod, f32, cut_params, rng)
    log(f"[lm {QWEN4_ARCH} bf16 card vs cpu] the same in bf16 compute (as registered), with the "
        f"request in {LM_SERVE['batch_slots']} slots and the f32-compute control")
    lm_card_vs_cpu(torch, lm_mod, cut, cut_params, rng, tol=BF16_LOGIT_TOL, tie=BF16_TIE_GAP,
                   control_cfg=f32)
    del params, cut_params
    torch.cuda.empty_cache()
    return errs


def flash_record(torch, fa, gen, cfg, slots: int, prompts) -> dict:
    """``flash_fwd`` in bf16 at a serve's prefill shapes (B ``slots`` and 1,
    each prompt length, causal, the LM's layout) against its plain twin
    (``flash_case``, which times it beside SDPA), then ``check_flash_padding``
    at the longest and the shortest.  Returns the record of the B ``slots``
    shapes, one call each."""
    d, hq, hkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    log(f"  flash_fwd in bf16 at the prefill shapes ({hq} heads over {hkv}, D {d} in the "
        f"{fa.flash_plan(d, torch.bfloat16).width}-wide tile, causal; the serve's B {slots} and "
        "the batch-1 runs'):")
    rec = product_record()
    for b in (slots, 1):
        for n in prompts:
            case = (b, hq, hkv, n, n, d, "causal", 0, None)
            r = flash_case(torch, fa, gen, case, "bfloat16", lm_layout=True)
            rec["max_abs_err"] = max(rec["max_abs_err"], r["max_abs_err"])
            if b == slots:
                for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes", "flops"):
                    rec[key] += r[key]
    rec["ops_ms"] = rec["flops"] / BF16_OPS_PER_S * 1e3
    for b, n in ((slots, max(prompts)), (1, min(prompts))):
        check_flash_padding(torch, fa, gen, b, hq, n, d)
    return set_bound_by(rec)


def check_flash_padding(torch, fa, gen, b: int, h: int, n: int, d: int,
                        mask: str = "causal") -> None:
    """``flash_fwd`` in bf16 at a head width D short of its tile's DP (the
    ``mask``, causal or full; B ``b``, ``h`` heads, S ``n``): against SDPA on
    the inputs upcast to f32 (the exact function) within ``FLASH_TOL``; and,
    launched on q, k, v views into rows of DP columns that hold NaN past D,
    into an output view of such rows, equal to the dense call bit for bit
    with the output's NaN columns untouched: no column past D is read or
    written."""
    import torch.nn.functional as F

    plan = fa.flash_plan(d, torch.bfloat16)
    rtol, atol = FLASH_TOL["bfloat16"]
    wide = torch.full((3, b, n, h, plan.width), float("nan"), device=CARD, dtype=torch.bfloat16)
    wide[..., :d] = torch.randn(3, b, n, h, d, generator=gen).to(CARD, torch.bfloat16)
    q, k, v = (t[..., :d].transpose(1, 2) for t in wide)
    dense = fa.flash_attention(*(t.contiguous() for t in (q, k, v)), mask=mask)
    exact = F.scaled_dot_product_attention(*(t.float() for t in (q, k, v)),
                                           is_causal=mask == "causal")
    err = (dense.float() - exact).abs().max().item()
    if not torch.allclose(dense.float(), exact, rtol=rtol, atol=atol):
        raise AssertionError(f"flash_fwd D {d} B {b} S {n}: max err {err} from SDPA in f32")
    out_wide = torch.full((b, n, h, plan.width), float("nan"), device=CARD, dtype=torch.bfloat16)
    out = out_wide[..., :d].transpose(1, 2)
    fa.FLASH_FWD(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, b, h, h,
                 n, n, d, *(st for t in (q, k, v, out) for st in t.stride()[:3]),
                 fa.MASKS[mask], 0, n, 1.0 / (d ** 0.5), plan.tile, fa.stream_of(q))
    torch.cuda.synchronize()
    if not torch.equal(out, dense):
        raise AssertionError(f"flash_fwd D {d} B {b} S {n}: the views into padded rows differ "
                             "from the dense call (a column past D was read)")
    if not torch.isnan(out_wide[..., d:].float()).all():
        raise AssertionError(f"flash_fwd D {d} B {b} S {n}: a column past D was written")
    log(f"  flash_fwd D {d} B {b} S {n} {mask}: within FLASH_TOL of SDPA on f32 inputs (max err "
        f"{err:.3e}); on views into {plan.width}-wide rows with NaN past D: equal to the dense "
        "call, no column past D written")


def batch_divergence(torch, lm_mod, cfg, params, prompt) -> None:
    """A prompt's prefill at batch 1 against its row of a
    ``RECURRENT_SERVE``-slot prefill (the other rows zero tokens), layer by
    layer: where the two first part and by how much (max|diff| over
    max|h| of that layer's output), at the last layer and at the logits.
    The first parting must be within one bf16 step of the row's scale (2^-7
    of max|h|): the two differ by roundings, not by a fault."""
    apply_layer, outs = lm_mod._apply_layer, []

    def spy(*args, **kw):
        out = apply_layer(*args, **kw)
        outs[-1].append(out[0][0].float())
        return out

    runs = []
    lm_mod._apply_layer = spy
    try:
        for b in (1, RECURRENT_SERVE["batch_slots"]):
            outs.append([])
            toks = torch.zeros((b, len(prompt)), dtype=torch.long)
            toks[0] = torch.as_tensor(prompt)
            model = lm_mod.LM(cfg, device=CARD)
            logits, _ = model.prefill(params, {"tokens": toks.to(CARD)},
                                      model.init_cache(b, RECURRENT_SERVE["cache_len"]))
            runs.append(logits[0, -1, :cfg.vocab_size].float())
    finally:
        lm_mod._apply_layer = apply_layer
    share = [((a - b).abs().max() / b.abs().max()).item() for a, b in zip(*outs)]
    first = next((i for i, d in enumerate(share) if d > 0), None)
    logit = ((runs[0] - runs[1]).abs().max() / runs[1].abs().max()).item()
    where = (f"first at layer {first} ({cfg.all_layers()[first].mixer}) by {share[first]:.3e}"
             if first is not None else "nowhere")
    log(f"  {cfg.compute_dtype} prefill of {len(prompt)} tokens, batch 1 against its row of "
        f"{RECURRENT_SERVE['batch_slots']} slots: they part {where} of max|h|, "
        f"{share[-1]:.3e} at the last layer, {logit:.3e} of max|logit|")
    if first is not None and share[first] > 2.0**-7:
        raise AssertionError(f"batch 1 and the slot row part at layer {first} by more than a "
                             "bf16 step")


def hold_recorded_f32(torch, arype, shapes, gen) -> None:
    """``mm_fused``'s f32 arm at every shape a serve in f32 compute recorded,
    against its plain twin (``hold_to_plain``; no timing: phase 2 times the
    f32 arm at the LM's shapes)."""
    rec = product_record()
    for m, k, n in shapes.get("mm_fused", {}):
        x = torch.randn(m, k, generator=gen).to(CARD)
        w = torch.randn(k, n, generator=gen).to(CARD)
        hold_to_plain(torch, f"mm_fused f32 ({m},{k},{n})", arype.arype_matmul(x, w),
                      arype.mm_fused(x, w), rec)
    log(f"  mm_fused's f32 arm at the {len(shapes.get('mm_fused', {}))} shapes that serve "
        f"recorded: within rtol {MATMUL_RTOL} of its plain twin (worst error "
        f"{rec['max_abs_err']:.3e})")


def recurrent_phase(torch, np, kernels, record_routes, lm_mod, serving, get_config, fa, arype,
                    vpe_matmul, vpe_mm, gen, arch: str) -> dict:
    """``[lm xlstm-1.3b]`` and ``[lm zamba2-2.7b]``: the recurrent arch at full
    width and depth as registered (f32 weights, bf16 compute), seed 0 on the
    card, serving ``RECURRENT_PROMPTS`` through ``ServeEngine`` at
    ``RECURRENT_SERVE``: tokens equal each request served alone at the same
    slots, and its batch-1 greedy run except counted near ties under
    ``BF16_TIE_GAP`` (xlstm: the batch-1 check in f32 compute, under
    ``RECURRENT_F32_TIE_GAP``, after ``batch_divergence`` in both types; see
    ``RECURRENT_BATCH1``); launches as counted from the code
    (``lm_forward_matmuls``: 97 ``mm_fused`` a forward for xlstm, 154 for
    zamba2; 9 ``flash_fwd`` a zamba2 prefill); prefill ms an admit, decode
    ms a step, tok/s and the serve's peak GB.  Then ``mm_fused``'s and
    ``vpe_mm``'s mixed arms at every shape the serve and the batch-1 runs
    recorded, timed beside ``torch.matmul``, and (zamba2) ``flash_fwd`` at
    the D 80 prefill shapes (``flash_record``); then one request in f32
    compute card vs CPU at full width and ``RECURRENT_CPU_SUPERBLOCKS``
    superblocks within ``LM_LOGIT_TOL``, beside what a one-ulp change of
    the embedding moves the CPU's own logits (the stack's conditioning);
    then in bf16 compute on the first layer of each mixer kind, card vs CPU
    and 4 slots vs batch 1 within ``BF16_LOGIT_TOL``, beside the
    f32-compute control.  Returns the kernels' records (``launches`` from
    this serve)."""
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm_mod.LM(cfg, device=CARD).init(torch.Generator(device=CARD).manual_seed(0))
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in RECURRENT_PROMPTS]
    mixers = ", ".join(f"{layer.mixer}/{layer.ffn}" for layer in cfg.block_pattern)
    log(f"[lm {arch}] as registered (compute {cfg.compute_dtype}, params {cfg.param_dtype}), "
        f"d_model {cfg.d_model}, superblock [{mixers}] x {cfg.num_superblocks}, "
        f"{cfg.num_heads} heads of {cfg.head_dim}, chunk {cfg.ssm_chunk}, vocab "
        f"{cfg.vocab_size}; {sum(t.numel() for t in leaves)} parameters "
        f"({sum(t.numel() * t.element_size() for t in leaves) / 1e9:.3f} GB, seed 0) in "
        f"{time.perf_counter() - t0:.2f} s; ServeConfig({RECURRENT_SERVE}), prompts "
        f"{list(RECURRENT_PROMPTS)}, max_new {RECURRENT_MAX_NEW}; near ties under "
        f"{BF16_TIE_GAP} counted; routed matmuls a forward {len(lm_forward_matmuls(cfg))}, "
        f"flash_fwd a prefill {attention_layers(cfg)}")
    shapes: dict = {}
    batch1 = RECURRENT_BATCH1[arch] == cfg.compute_dtype
    counts, st, singles, _ = serve_lm(torch, kernels, record_routes, lm_mod, serving, cfg, params,
                                      prompts, serve=RECURRENT_SERVE, max_new=RECURRENT_MAX_NEW,
                                      near_tie=BF16_TIE_GAP, alone=True, shapes=shapes,
                                      batch1=batch1)
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB (weights, the "
        f"serve's caches and the single-request runs')")
    if not batch1:
        held = cfg.replace(compute_dtype=RECURRENT_BATCH1[arch])
        for c in (cfg, held):
            batch_divergence(torch, lm_mod, c, params, prompts[0])
        log(f"[lm {arch} {held.compute_dtype}] the same requests in {held.compute_dtype} compute, "
            f"held to their batch-1 runs (near ties under {RECURRENT_F32_TIE_GAP} counted)")
        held_shapes: dict = {}
        serve_lm(torch, kernels, record_routes, lm_mod, serving, held, params, prompts,
                 serve=RECURRENT_SERVE, max_new=RECURRENT_MAX_NEW,
                 near_tie=RECURRENT_F32_TIE_GAP, shapes=held_shapes)
        hold_recorded_f32(torch, arype, held_shapes, gen)
    engines = {"mm_fused": (arype.arype_matmul, arype.mm_fused, arype.card_plan),
               "vpe_mm": (vpe_matmul, vpe_mm, None)}
    recs = check_recorded_mixed(torch, cfg, shapes, engines, gen)
    recs["mm_fused"]["launches"] = counts["mm_fused"]
    if "vpe_mm" in recs:
        recs["vpe_mm"]["launches"] = singles["vpe_mm"]
    else:  # every projection's M·K·N is past vpe_max_elems, even at one row
        log("  vpe_mm: no shape recorded (the router placed every projection on the AryPE, "
            "batch 1 too)")
    if attention_layers(cfg):
        recs["flash_fwd"] = flash_record(torch, fa, gen, cfg, RECURRENT_SERVE["batch_slots"],
                                         RECURRENT_PROMPTS)
        recs["flash_fwd"]["launches"] = counts["flash_fwd"]

    cut = cfg.replace(num_superblocks=RECURRENT_CPU_SUPERBLOCKS, compute_dtype="float32")
    cut_params = dict(params, blocks=_stack_head(params["blocks"], RECURRENT_CPU_SUPERBLOCKS))
    log(f"[lm {arch} card vs cpu] full width, {RECURRENT_CPU_SUPERBLOCKS} of "
        f"{cfg.num_superblocks} superblocks, f32 compute, batch 1, a {LM_CPU_PROMPT}-token "
        f"prompt, prefill + {LM_CPU_DECODES} decode steps")
    lm_card_vs_cpu(torch, lm_mod, cut, cut_params, rng)
    cpu = _tree_to(cut_params, "cpu")
    tokens = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, LM_CPU_PROMPT)))}
    model = lm_mod.LM(cut, device="cpu")
    base, _ = model.prefill(cpu, tokens, model.init_cache(1, RECURRENT_SERVE["cache_len"]))
    nudged, _ = model.prefill(dict(cpu, embed=cpu["embed"] * (1 + 2.0**-23)), tokens,
                              model.init_cache(1, RECURRENT_SERVE["cache_len"]))
    log(f"  conditioning: a one-ulp change of the embedding moves the CPU's own prefill logits "
        f"by {((nudged - base).abs().max() / base.abs().max()).item():.3e} of max|logit|")
    # bf16 compute (as registered) on the first layer of each mixer kind of
    # the first superblock (xlstm: one mLSTM and the sLSTM; zamba2: one
    # mamba2 and the shared block), beside the f32-compute control, as
    # [lm qwen3-4b] is at 4 superblocks.  Deeper, bf16's own roundings swamp
    # the logits: over xlstm's whole first superblock card vs CPU read
    # 1.082e-01 of max|logit| (control 1.713e-01), over its first mLSTM and
    # the sLSTM 5.619e-03 (control 1.370e-02); over zamba2's whole
    # superblock 1.044e-02 (control 1.628e-02), on an H100 80GB HBM3 at 700 W
    first = {}
    for i, layer in enumerate(cfg.block_pattern):
        first.setdefault(layer.mixer, i)
    keep = sorted(first.values())
    one = cut.replace(block_pattern=tuple(cfg.block_pattern[i] for i in keep))
    one_params = dict(cut_params, blocks={f"l{j}": cut_params["blocks"][f"l{i}"]
                                          for j, i in enumerate(keep)})
    log(f"[lm {arch} bf16 card vs cpu] full width, layers {keep} of the first superblock (the "
        f"first of each mixer kind), bf16 compute (as registered), with the request in "
        f"{LM_SERVE['batch_slots']} slots and the f32-compute control")
    lm_card_vs_cpu(torch, lm_mod, one.replace(compute_dtype=cfg.compute_dtype), one_params, rng,
                   tol=BF16_LOGIT_TOL, tie=BF16_TIE_GAP, control_cfg=one)
    del params, cut_params, cpu, one_params
    torch.cuda.empty_cache()
    return recs


def counted_run(torch, kernels, record_routes, fn, want: dict, label: str, shapes: dict):
    """``fn()`` with every launch count at 0 just before and read just
    after, ended by a device sync and timed on the host clock: the counts
    must be ``want`` (every other kernel 0) and what the run's recorded
    matmuls launch (``matmul_launches``; the flash launches aside), and the
    recorded shapes go to ``shapes`` (``note_shapes``).  Returns (fn's
    result, the counts, ms)."""
    kernels.reset_launches()
    t0 = time.perf_counter()
    with record_routes() as routes:
        out = fn()
        sync(torch)
    ms = (time.perf_counter() - t0) * 1e3
    counts = expect_launches(kernels, want, label)
    recorded = kernels.matmul_launches(routes)
    recorded["flash_fwd"] = counts["flash_fwd"]
    if recorded != counts:
        raise AssertionError(f"{label}: launches {counts}, recorded routes {recorded}")
    note_shapes(kernels, routes, label, shapes)
    return out, counts, ms


def share_of(a, b) -> float:
    """max|a - b| as a share of max|b|."""
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def add_counts(total: dict, counts: dict) -> None:
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


def hubert_phase(torch, np, kernels, record_routes, lm_mod, get_config, fa, arype, vpe_matmul,
                 vpe_mm, gen) -> dict:
    """``[lm hubert-xlarge]``: hubert-xlarge at full width and depth as
    registered (f32 weights, bf16 compute, encoder-only: seeded f32 frames
    in, no embedding), seed 0 on the card.  ``LM.forward`` (per-frame logits
    over the 504 units) and ``LM.loss`` on seeded labels at each of
    ``HUBERT_BATCHES``; ``LM.prefill`` at each of ``HUBERT_PREFILLS``.  Each
    run's launches as counted from the code (a forward: 289 ``mm_fused``, 48
    ``flash_fwd``; the batch-1 prefill's head on ``vpe_mm``); forward ms,
    frames/s and peak GB; the prefills' last-position logits within
    ``HUBERT_PREFILL_TOL`` of max|logit| of the forward's.  Then the mixed
    arms at every recorded shape against their plain twins, timed beside
    ``torch.matmul(x.float(), w).to(out)``, the gelu epilogue at the
    ``wi_up`` shapes; ``flash_fwd`` at the full-mask shapes (D 80 in the
    128-wide tile) against its plain twin and SDPA, and on views into
    NaN-padded rows; the forward card vs CPU in f32 compute at full width
    and ``HUBERT_CPU_SUPERBLOCKS`` superblocks within ``LM_LOGIT_TOL``.
    Returns the kernels' records (``launches``: every run of the phase)."""
    cfg = get_config(HUBERT_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm_mod.LM(cfg, device=CARD)
    params = model.init(torch.Generator(device=CARD).manual_seed(0))
    sync(torch)
    leaves = list(_leaves(params))
    log(f"[lm {HUBERT_ARCH}] as registered (compute {cfg.compute_dtype}, params "
        f"{cfg.param_dtype}), encoder-only, {cfg.frontend} (no embedding), d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads of {cfg.head_dim}, the full mask, gelu MLP "
        f"{cfg.d_ff}, {cfg.num_layers} layers, {cfg.vocab_size} units; "
        f"{sum(t.numel() for t in leaves)} parameters "
        f"({sum(t.numel() * t.element_size() for t in leaves) / 1e9:.3f} GB, seed 0) in "
        f"{time.perf_counter() - t0:.2f} s; forward and loss at (B, S) {list(HUBERT_BATCHES)}, "
        f"prefill at {list(HUBERT_PREFILLS)}")
    g = torch.Generator(device=CARD).manual_seed(3)
    frames = {bs: torch.randn(*bs, cfg.d_model, generator=g, device=CARD)
              for bs in HUBERT_BATCHES}
    per_forward, attn = len(lm_forward_matmuls(cfg)), attention_layers(cfg)
    shapes, total, forwards = {}, {}, {}
    for b, s in HUBERT_BATCHES:
        x = frames[b, s]
        labels = torch.randint(0, cfg.vocab_size, (b, s), generator=g, device=CARD)
        want = {"mm_fused": per_forward, "flash_fwd": attn}
        (logits, _), counts, _ = counted_run(
            torch, kernels, record_routes, lambda: model.forward(params, {"frames": x}), want,
            f"forward B{b} S{s}", shapes)
        if logits.shape != (b, s, cfg.padded_vocab) or not torch.isfinite(logits).all():
            raise AssertionError(f"forward B{b} S{s}: logits {tuple(logits.shape)} not finite")
        (loss, _), lcounts, _ = counted_run(
            torch, kernels, record_routes,
            lambda: model.loss(params, {"frames": x, "labels": labels}), want,
            f"loss B{b} S{s}", shapes)
        if not torch.isfinite(loss):
            raise AssertionError(f"loss B{b} S{s}: {float(loss)}")
        add_counts(total, counts)
        add_counts(total, lcounts)
        forwards[b, s] = logits
        ms = wall_ms(torch, lambda: model.forward(params, {"frames": x}), reps=3)
        log(f"  forward B {b} x {s} frames: {ms:.3f} ms, {b * s / ms * 1e3:.1f} frames/s; loss "
            f"{float(loss):.6f} (ln {cfg.vocab_size} = {np.log(cfg.vocab_size):.6f}); a forward "
            f"and a loss each launched {counts_text(counts)}")
    fb, fs = HUBERT_BATCHES[0]
    for b, s in HUBERT_PREFILLS:
        if s != fs or b > fb:
            raise AssertionError(f"prefill B{b} S{s} is not a part of the forward's batch")
        # the head's few rows: at one row the router places it on the VPE
        head_vpe = int(b == 1)
        want = {"mm_fused": per_forward - head_vpe, "vpe_mm": head_vpe, "flash_fwd": attn}
        (logits, cache), counts, ms = counted_run(
            torch, kernels, record_routes,
            lambda: model.prefill(params, {"frames": frames[fb, fs][:b]}, model.init_cache(b, s)),
            want, f"prefill B{b} S{s}", shapes)
        add_counts(total, counts)
        dist = share_of(logits[:, 0, :cfg.vocab_size], forwards[fb, fs][:b, -1, :cfg.vocab_size])
        log(f"  prefill B {b} x {s} frames: {ms:.3f} ms, launches {counts_text(counts)}; its "
            f"last-position logits {dist:.3e} of max|logit| from the forward's (limit "
            f"{HUBERT_PREFILL_TOL})")
        if dist > HUBERT_PREFILL_TOL or int(cache["lengths"][0]) != s:
            raise AssertionError(f"prefill B{b}: {dist:.3e} of max|logit| from the forward")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB; launches over "
        f"the phase's runs {counts_text(total)}")

    engines = {"mm_fused": (arype.arype_matmul, arype.mm_fused, arype.card_plan),
               "vpe_mm": (vpe_matmul, vpe_mm, None)}
    recs = check_recorded_mixed(torch, cfg, shapes, engines, gen)
    gelu = product_record()
    for m, k, n in shapes["mm_fused"]:
        if (k, n) == (cfg.d_model, cfg.d_ff):  # wi_up, the gelu epilogue
            x = torch.randn(m, k, generator=gen).to(CARD, torch.bfloat16)
            w = torch.randn(k, n, generator=gen).to(CARD)
            out = arype.arype_matmul(x, w, activation="gelu")
            if not torch.equal(out, arype.arype_matmul(x.float(), w, activation="gelu")
                               .to(torch.bfloat16)):
                raise AssertionError(f"mm_fused gelu ({m},{k},{n}): differs from the f32 arm")
            hold_to_plain(torch, f"mm_fused gelu ({m},{k},{n})", out,
                          arype.mm_fused(x, w, activation="gelu"), gelu)
    log(f"  mm_fused's gelu epilogue at the wi_up shapes: bit for bit the f32 arm on x.float(), "
        f"worst error from the twin {gelu['max_abs_err']:.3e}")
    recs["mm_fused"]["max_abs_err"] = max(recs["mm_fused"]["max_abs_err"], gelu["max_abs_err"])
    for name in ("mm_fused", "vpe_mm"):
        recs[name]["launches"] = total[name]

    d, h = cfg.head_dim, cfg.num_heads
    log(f"  flash_fwd in bf16 at the forward and prefill shapes ({h} heads, D {d} in the "
        f"{fa.flash_plan(d, torch.bfloat16).width}-wide tile, full mask):")
    frec = product_record()
    for b, s in (*HUBERT_BATCHES, *[bs for bs in HUBERT_PREFILLS if bs not in HUBERT_BATCHES]):
        r = flash_case(torch, fa, gen, (b, h, h, s, s, d, "full", 0, None), "bfloat16",
                       lm_layout=True)
        frec["max_abs_err"] = max(frec["max_abs_err"], r["max_abs_err"])
        for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes", "flops"):
            frec[key] += r[key]
        check_flash_padding(torch, fa, gen, b, h, s, d, mask="full")
    frec["ops_ms"] = frec["flops"] / BF16_OPS_PER_S * 1e3
    recs["flash_fwd"] = set_bound_by(frec)
    recs["flash_fwd"]["launches"] = total["flash_fwd"]

    cut = cfg.replace(num_superblocks=HUBERT_CPU_SUPERBLOCKS, compute_dtype="float32")
    cut_params = dict(params, blocks=_stack_head(params["blocks"], HUBERT_CPU_SUPERBLOCKS))
    b, s = HUBERT_BATCHES[-1]
    x = frames[b, s]
    card = lm_mod.LM(cut, device=CARD).forward(cut_params, {"frames": x})[0].cpu()
    cpu_model, cpu_params = lm_mod.LM(cut, device="cpu"), _tree_to(cut_params, "cpu")
    cpu = cpu_model.forward(cpu_params, {"frames": x.cpu()})[0]
    moved = share_of(cpu_model.forward(cpu_params, {"frames": x.cpu() * (1 + 2.0**-23)})[0], cpu)
    dist = share_of(card, cpu)
    log(f"[lm {HUBERT_ARCH} card vs cpu] full width, {HUBERT_CPU_SUPERBLOCKS} of "
        f"{cfg.num_superblocks} superblocks, f32 compute, forward B {b} x {s}: logits "
        f"{dist:.3e} of max|logit| apart (limit {LM_LOGIT_TOL}); a one-ulp change of the "
        f"frames moves the CPU's own by {moved:.3e}")
    if dist > LM_LOGIT_TOL:
        raise AssertionError(f"{HUBERT_ARCH} card vs cpu: {dist:.3e} of max|logit|")
    del params, cut_params, cpu_params, forwards, frames
    torch.cuda.empty_cache()
    return recs


def vision_phase(torch, np, kernels, record_routes, lm_mod, get_config, fa, arype, gen) -> dict:
    """``[lm llama-3.2-vision-90b]``: llama-3.2-vision-90b at full width,
    ``VISION_SUPERBLOCKS`` of its 20 superblocks (8 self and 2 cross
    layers), otherwise as registered (bf16 weights and compute, 1600 image
    tokens), seed 0 on the card, the peak of the init logged.
    ``VISION_REQUESTS`` requests of ``VISION_PROMPT`` tokens, each with its
    own bf16 image embeddings: ``LM.prefill`` at B 4 with ``VISION_CACHE``
    cache rows, then ``VISION_MAX_NEW`` greedy ``decode_step``s; launches as
    counted from the code (a prefill 71 ``mm_fused`` and 10 ``flash_fwd``, a
    decode step 67 and 2: a cross layer decodes with q and o only, through
    the flash kernel); prefill ms, decode ms a step, tok/s and peak GB; each
    row's tokens equal its request run alone at batch 1 except counted near
    ties under ``BF16_TIE_GAP``.  Then ``mm_fused``'s bf16-weight arm at
    every recorded shape (the cross k/v over the image rows included) bit
    for bit with the f32 arm on upcast operands, within one bf16 step of its
    plain twin, timed beside ``torch.matmul`` on the same operands and its
    bound; ``flash_fwd`` at the self and both cross shapes against its plain
    twin and SDPA; in f32 compute at the same depth, a prefill of
    ``VISION_DECODE_CHECK[0]`` tokens and teacher-forced decode steps held
    to the forward's logits: with the bf16 KV cache within
    ``BF16_LOGIT_TOL``, with an f32 cache (the control: decode's arithmetic
    without the cache's rounding) within ``DECODE_F32_TOL`` of max|logit|;
    and card vs CPU in f32
    compute at full width on one self layer and the cross layer, the added
    output (out - x) within ``LM_LOGIT_TOL`` of its max.  Returns the
    kernels' records."""
    cfg = get_config(VISION_ARCH).replace(num_superblocks=VISION_SUPERBLOCKS)
    bf16, v = torch.bfloat16, cfg.vocab_size
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm_mod.LM(cfg, device=CARD)
    params = model.init(torch.Generator(device=CARD).manual_seed(0))
    sync(torch)
    leaves = list(_leaves(params))
    mixers = ", ".join(f"{layer.mixer}/{layer.ffn}" for layer in cfg.block_pattern)
    log(f"[lm {VISION_ARCH}] full width, {cfg.num_superblocks} of "
        f"{get_config(VISION_ARCH).num_superblocks} superblocks [{mixers}], otherwise as "
        f"registered (compute {cfg.compute_dtype}, params {cfg.param_dtype}): d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads over {cfg.num_kv_heads}, head_dim {cfg.head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {v}, {cfg.num_image_tokens} image tokens; "
        f"{sum(t.numel() for t in leaves)} parameters "
        f"({sum(t.numel() * t.element_size() for t in leaves) / 1e9:.3f} GB, seed 0) in "
        f"{time.perf_counter() - t0:.2f} s, peak {torch.cuda.max_memory_allocated() / 1e9:.3f} GB "
        f"allocated while drawing; {VISION_REQUESTS} requests of {VISION_PROMPT} tokens with "
        f"their own image embeddings, {VISION_MAX_NEW} decode steps, {VISION_CACHE} cache rows")
    rng = np.random.default_rng(8)
    prompts = rng.integers(0, v, (VISION_REQUESTS, VISION_PROMPT))
    g = torch.Generator(device=CARD).manual_seed(4)
    images = torch.randn(VISION_REQUESTS, cfg.num_image_tokens, cfg.d_model, generator=g,
                         device=CARD).to(bf16)
    toks = torch.as_tensor(prompts).to(CARD)
    cross = sum(layer.mixer == "attn_cross" for layer in cfg.all_layers())
    shapes, total = {}, {}
    cache = model.init_cache(VISION_REQUESTS, VISION_CACHE)
    (logits, cache), counts, prefill_ms = counted_run(
        torch, kernels, record_routes,
        lambda: model.prefill(params, {"tokens": toks, "vision": images}, cache),
        {"mm_fused": len(lm_forward_matmuls(cfg)), "flash_fwd": attention_layers(cfg)},
        "prefill", shapes)
    add_counts(total, counts)
    nxt = logits[:, -1, :v].argmax(-1, keepdim=True)
    out, decode_ms = [nxt.cpu()], []
    for step in range(VISION_MAX_NEW):
        (logits, cache), dcounts, ms = counted_run(
            torch, kernels, record_routes,
            lambda: model.decode_step(params, {"tokens": nxt}, cache),
            {"mm_fused": len(lm_forward_matmuls(cfg, decode=True)), "flash_fwd": cross},
            f"decode step {step}", shapes)
        add_counts(total, dcounts)
        nxt = logits[:, -1, :v].argmax(-1, keepdim=True)
        out.append(nxt.cpu())
        decode_ms.append(ms)
    tokens = torch.cat(out, dim=1).tolist()
    generated = VISION_REQUESTS * (1 + VISION_MAX_NEW)
    log(f"  prefill {prefill_ms:.3f} ms (B {VISION_REQUESTS} x {VISION_PROMPT} tokens and "
        f"{cfg.num_image_tokens} image rows each), decode {statistics.median(decode_ms):.3f} ms "
        f"a step (median; {min(decode_ms):.3f}-{max(decode_ms):.3f}), "
        f"{generated / (prefill_ms + sum(decode_ms)) * 1e3:.2f} generated tok/s; launches a "
        f"prefill {counts_text(counts)}, a decode step {counts_text(dcounts)}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    ties = 0
    with record_routes() as single_routes:
        for i in range(VISION_REQUESTS):
            ref, gaps = greedy_single(torch, lm_mod.LM(cfg, device=CARD), params, prompts[i],
                                      VISION_MAX_NEW + 1, VISION_CACHE,
                                      extra={"vision": images[i:i + 1]})
            if tokens[i] == ref:
                continue
            t = next(j for j, (a, b) in enumerate(zip(tokens[i], ref)) if a != b)
            if gaps[t] >= BF16_TIE_GAP:
                raise AssertionError(f"request {i}: batch {tokens[i]} != alone {ref} (top-2 gap "
                                     f"at token {t}: {gaps[t]:.3e} of max|logit|)")
            log(f"  request {i}: token {t} differs at a near tie of the batch-1 run (top-2 gap "
                f"{gaps[t]:.3e} of max|logit| < {BF16_TIE_GAP})")
            ties += 1
    note_shapes(kernels, single_routes, "batch 1", shapes)
    log(f"  each row's {VISION_MAX_NEW + 1} tokens equal its request run alone at batch 1 "
        f"except {ties} near ties")

    recs = check_recorded_mixed(
        torch, cfg, shapes, {"mm_fused": (arype.arype_matmul, arype.mm_fused, arype.card_plan)},
        gen, w_dtype=bf16)
    if set(recs) != {"mm_fused"}:
        raise AssertionError(f"{VISION_ARCH} launched {sorted(recs)}: every matmul is past the "
                             "VPE's cap, so mm_fused alone")
    recs["mm_fused"]["launches"] = total["mm_fused"]

    d, hq, hkv, t_img = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads, cfg.num_image_tokens
    log(f"  flash_fwd in bf16 at the self prefill (causal) and the cross shapes (full mask, "
        f"{hq} heads over {hkv}, D {d}, Sk {t_img}), B {VISION_REQUESTS} and 1:")
    frec, sq1 = product_record(), {}
    for b in (VISION_REQUESTS, 1):
        for sq, sk, mask in ((VISION_PROMPT, VISION_PROMPT, "causal"),
                             (VISION_PROMPT, t_img, "full"), (1, t_img, "full")):
            r = flash_case(torch, fa, gen, (b, hq, hkv, sq, sk, d, mask, 0, None), "bfloat16",
                           lm_layout=True)
            frec["max_abs_err"] = max(frec["max_abs_err"], r["max_abs_err"])
            if b == VISION_REQUESTS:
                for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes", "flops"):
                    frec[key] += r[key]
            if sq == 1:
                sq1[b] = r["ms"] / r["library_ms"]
    frec["ops_ms"] = frec["flops"] / BF16_OPS_PER_S * 1e3
    recs["flash_fwd"] = set_bound_by(frec)
    recs["flash_fwd"]["launches"] = total["flash_fwd"]
    log("  flash_fwd at Sq 1 against the 1600 image keys (63 of a tile's 64 query rows dead): "
        + ", ".join(f"B {b} {f:.2f}x SDPA" for b, f in sq1.items()))

    f32 = cfg.replace(compute_dtype="float32")
    m32 = lm_mod.LM(f32, device=CARD)
    p0, steps = VISION_DECODE_CHECK
    seq, img = toks[:1, :p0 + steps], images[:1]
    fwd = m32.forward(params, {"tokens": seq, "vision": img})[0][0, p0:, :v]
    scale, worst = fwd.abs().max().item(), {}
    for kv in ("bf16", "f32"):
        c = m32.init_cache(1, VISION_CACHE)
        if kv == "f32":  # the control: the self-attention keys and values unrounded
            c = dict(c, blocks={name: layer._replace(k=layer.k.float(), v=layer.v.float())
                                for name, layer in c["blocks"].items()})
        _, c = m32.prefill(params, {"tokens": seq[:, :p0], "vision": img}, c)
        worst[kv] = 0.0
        for t in range(p0, p0 + steps):
            lg, c = m32.decode_step(params, {"tokens": seq[:, t:t + 1]}, c)
            worst[kv] = max(worst[kv], (lg[0, 0, :v] - fwd[t - p0]).abs().max().item())
    log(f"[lm {VISION_ARCH} decode vs forward] f32 compute, {cfg.num_superblocks} superblocks, "
        f"prefill {p0} tokens and {steps} teacher-forced decode steps against the forward's "
        f"logits (max|logit| {scale:.4f}): with the bf16 KV cache (as served) "
        f"{worst['bf16'] / scale:.3e} of max|logit| (limit {BF16_LOGIT_TOL}), with an f32 "
        f"cache {worst['f32'] / scale:.3e} (limit {DECODE_F32_TOL})")
    del fwd, c

    x = torch.randn(1, VISION_CPU_TOKENS, cfg.d_model, generator=g, device=CARD)
    img = images[:1].float()
    log(f"[lm {VISION_ARCH} card vs cpu] full width, f32 compute, B 1 x {VISION_CPU_TOKENS} "
        f"tokens against {t_img} image rows, one layer each on the same input:")
    for idx in (0, next(i for i, layer in enumerate(cfg.block_pattern)
                        if layer.mixer == "attn_cross")):
        spec = cfg.block_pattern[idx]
        lp = {part: {name: leaf[0] for name, leaf in tree.items()}
              for part, tree in params["blocks"][f"l{idx}"].items()}
        card = (lm_mod._apply_layer(lp, None, x, f32, spec, mode="train", cross_kv=img)[0]
                - x).cpu()
        cpu_x = x.cpu()
        cpu = lm_mod._apply_layer(_tree_to(lp, "cpu"), None, cpu_x, f32, spec, mode="train",
                                  cross_kv=img.cpu())[0] - cpu_x
        dist = share_of(card, cpu)
        log(f"  layer {idx} ({spec.mixer}/{spec.ffn}): the added output (out - x) {dist:.3e} of "
            f"its max apart (limit {LM_LOGIT_TOL})")
        if dist > LM_LOGIT_TOL:
            raise AssertionError(f"{VISION_ARCH} layer {idx} card vs cpu: {dist:.3e}")
    del params, cache, images, leaves
    torch.cuda.empty_cache()
    # held last, so that a run prints every reading first
    if worst["bf16"] > BF16_LOGIT_TOL * scale or worst["f32"] > DECODE_F32_TOL * scale:
        raise AssertionError(f"decode vs forward: {worst} (max|logit| {scale:.4f})")
    return recs


class ArmSpy:
    """Counts the AryPE engine calls ``router.matmul`` makes, forward and
    backward, by (x, w, out) dtype, with the distinct (m, k, n, activation)
    each ran, by standing in for ``router.arype_matmul`` inside the block
    (the kernel's own launch count must equal their sum)."""

    def __init__(self, router):
        self.router, self.engine = router, router.arype_matmul
        self.calls: dict = {}  # arm -> calls
        self.shapes: dict = {}  # (arm, (m, k, n)) -> calls

    def __enter__(self):
        def spy(x, w, *, activation="none", out_dtype=None):
            out = self.engine(x, w, activation=activation, out_dtype=out_dtype)
            arm, shape = (x.dtype, w.dtype, out.dtype), (x.shape[0], x.shape[1], w.shape[1])
            self.calls[arm] = self.calls.get(arm, 0) + 1
            self.shapes[arm, shape] = self.shapes.get((arm, shape), 0) + 1
            return out

        self.router.arype_matmul = spy
        return self

    def __exit__(self, *exc):
        self.router.arype_matmul = self.engine


def arm_name(torch, arm) -> str:
    short = {torch.float32: "f32", torch.bfloat16: "bf16"}
    return f"mm_fused ({short[arm[0]]} x, {short[arm[1]]} w -> {short[arm[2]]})"


def disk_free_gb(path) -> float:
    import shutil

    return shutil.disk_usage(path).free / 1e9


def tree_share(torch, got, want) -> tuple[float, str]:
    """The largest max|got - want| / max|want| over the leaves of two trees
    of the same structure (``tree_items``), and its leaf."""
    from repro_torch.common.tree import tree_items

    worst, where = 0.0, ""
    for (key, a), (_, b) in zip(tree_items(got), tree_items(want)):
        b = b.float().cpu()
        share = ((a.float().cpu() - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
        if share > worst:
            worst, where = share, key
    return worst, where


def tree_l2(torch, got, want) -> tuple[float, float, tuple[float, str]]:
    """||got - want|| / ||want|| over all the leaves of two trees of the same
    structure, its median over the leaves, and the worst leaf's with its
    path."""
    from repro_torch.common.tree import tree_items

    num = den = 0.0
    per_leaf = []
    for (key, a), (_, b) in zip(tree_items(got), tree_items(want)):
        a, b = a.double().cpu(), b.double().cpu()
        d2, b2 = (a - b).pow(2).sum().item(), b.pow(2).sum().item()
        num, den = num + d2, den + b2
        per_leaf.append(((d2 / max(b2, 1e-300)) ** 0.5, key))
    per_leaf.sort()
    return (num / max(den, 1e-300)) ** 0.5, per_leaf[len(per_leaf) // 2][0], per_leaf[-1]


def check_backward_arms(torch, router, arype, cfg, gen, rows: int) -> dict:
    """The backward of every distinct routed matmul of a qwen3 layer and the
    head at ``rows`` tokens, as training runs it (bf16 x on f32 w; the
    layers' outputs bf16, the head's f32): operands drawn from ``gen``, one
    ``router.matmul`` forward and ``backward`` on the card, dX and dW bit for
    bit the kernel called directly on the transposed operands (after the
    recomputed f32 product for the silu gate); then each backward product
    (and the recompute) against the plain twin on the card
    (:func:`hold_to_plain`) and timed beside ``torch.matmul`` and the bound
    (:func:`time_product`: on the tf32x3 variant dX takes 3 x 2MKN, dW and
    the recompute 2 x 2MKN).  Each shape's plan is logged, with the
    transposes' copies.  Returns a record per arm (name -> sums over its
    shapes, as the kernels line takes them)."""
    from repro_torch.common.util import activation_vjp
    from repro_torch.runtime import RuntimeConfig

    bf16, f32 = torch.bfloat16, torch.float32
    d, f, q, kv = cfg.d_model, cfg.d_ff, cfg.q_dim, cfg.kv_dim
    layers = [("wq", d, q, "none", bf16), ("wk", d, kv, "none", bf16), ("wo", q, d, "none", bf16),
              ("wi_gate", d, f, "silu", bf16), ("wo_mlp", f, d, "none", bf16),
              ("lm_head", d, cfg.padded_vocab, "none", f32)]
    recs: dict = {}
    transposes = 0.0
    for name, k, n, act, od in layers:
        x = torch.randn(rows, k, generator=gen).to(CARD, bf16).requires_grad_()
        w = (torch.randn(k, n, generator=gen) * k ** -0.5).to(CARD).requires_grad_()
        ct = torch.randn(rows, n, generator=gen).to(CARD, od)
        out = router.matmul(x, w, activation=act, out_dtype=od,
                            config=RuntimeConfig.from_arch(cfg))
        out.backward(ct)
        with torch.no_grad():
            g = ct.float()
            if act != "none":
                g = activation_vjp(arype.arype_matmul(x, w, out_dtype=f32), g, act)
            wt, xt = w.t().contiguous(), x.t().contiguous()
            t_wt = time_ms(lambda: w.t().contiguous(), calls=5)
            t_xt = time_ms(lambda: x.t().contiguous(), calls=5)
            transposes += t_wt + t_xt
            products = [("dX", g, wt, bf16, x.grad), ("dW", xt, g, f32, w.grad)]
            if act != "none":
                products.append(("recompute", x.detach(), w.detach(), f32, None))
            for label, a, b, o, got in products:
                m, kk, nn = a.shape[0], a.shape[1], b.shape[1]
                direct = arype.arype_matmul(a, b, out_dtype=o)
                if got is not None and not torch.equal(got, direct):
                    raise AssertionError(f"{name} {label} ({m},{kk},{nn}): the backward differs "
                                         "from the kernel called directly")
                arm = arm_name(torch, (a.dtype, b.dtype, o))
                rec = recs.setdefault(arm, product_record())
                err = hold_to_plain(torch, f"{arm} {name} {label} ({m},{kk},{nn})", direct,
                                    arype.mm_fused(a, b, out_dtype=o), rec)
                time_product(torch, arype.arype_matmul, arype.mm_fused, a, b, o, rec,
                             f"{arm} {name} {label} (max err {err:.3e})", arype.card_plan,
                             plain_calls=2, plain_reps=3)
            log(f"  {name}: the transposes' copies w^T ({k}x{n} f32) {t_wt:.5f} ms, x^T "
                f"({rows}x{k} bf16) {t_xt:.5f} ms")
        del x, w, ct, out
    log(f"  the transposes of one layer's distinct shapes and the head: {transposes:.5f} ms")
    return {arm: set_bound_by(rec) for arm, rec in recs.items()}


def profile_train(torch, step_fn, params, opt_state, batch, step_ms: float, steps: int = 2
                  ) -> None:
    """Device-busy time of ``steps`` train steps from a torch.profiler trace
    (each step ending in its loss's read-back) against the unprofiled step
    time ``step_ms`` (the trace's own wall time carries the profiler's
    cost): the device's idle share; and the kernels that took the most
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            params, opt_state, metrics = step_fn(params, opt_state, i, batch)
            float(metrics["loss"])
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / steps / 1e3
    if busy_ms == 0:
        log("[profile] the trace holds no device time: idle share not measured")
        return
    log(f"[profile] train, {steps} steps: device busy {busy_ms:.3f} ms a step of {step_ms:.3f} ms "
        f"unprofiled ({wall_ms:.3f} ms traced), idle share {1 - busy_ms / step_ms:.4f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:14]:
        log(f"  {e.self_device_time_total / steps / 1e3:9.3f} ms/step  "
            f"{e.count // steps:5d}/step  {e.key[:90]}")


def train_phase(torch, np, kernels, get_config, arype, gen, profile: bool = False) -> dict:
    """``[train qwen3-0.6b]``: qwen3-0.6b as registered (f32 weights, bf16
    compute, AdamW on the cosine schedule) trained by ``Trainer.run`` at
    full width and depth for ``TRAIN_STEPS`` steps of the token pipeline,
    saving once at the last step: the loss of each step finite; each step's
    wall ms (step and loss read-back), host enqueue ms and device ms
    between CUDA events; tokens/s; peak memory; the seconds of the save;
    launches exactly as predicted from the code (each of the 197 forward
    matmuls and its dX and dW, each silu gate recomputed: 619 ``mm_fused`` a
    step; one ``flash_fwd`` a layer), with each (x, w, out) arm's count.
    Then :func:`check_backward_arms` at the step's 1024 rows; one train step
    card against CPU at full width and ``TRAIN_CPU_SUPERBLOCKS`` superblocks
    (f32 compute held to ``TRAIN_LOSS_RTOL``/``TRAIN_SHARE``; bf16 compute
    printed beside the f32-compute control); and ``TRAIN_RESUME_STEPS``
    steps straight against a run that fails at step 3 and resumes from its
    step-2 checkpoint, at that depth: the same losses and final parameters,
    bit for bit.  Returns the backward arms' records."""
    import shutil

    from repro_torch.common.tree import tree_items, tree_map
    from repro_torch.common.util import apply_activation
    from repro_torch.core import router
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.optim import clip_by_global_norm, make_optimizer
    from repro_torch.train.loop import Trainer, TrainLoopConfig
    from repro_torch.train.steps import grads_of

    cfg = get_config(TRAIN_ARCH)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    log(f"[train {TRAIN_ARCH}] as registered (params {cfg.param_dtype}, compute "
        f"{cfg.compute_dtype}, {cfg.optimizer}), {cfg.num_layers} layers, vocab "
        f"{cfg.vocab_size}; Trainer.run, {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens, one checkpoint at the last step into {TRAIN_CKPT} "
        f"({disk_free_gb(ROOT):.1f} GB free)")
    loop = TrainLoopConfig(total_steps=TRAIN_STEPS, checkpoint_every=10**9, log_every=10**9,
                           checkpoint_dir=str(TRAIN_CKPT / "full"))
    data = TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_BATCH)
    trainer = Trainer(cfg, loop, data, device=CARD)
    split = []
    step_fn, save_fn, wait_fn = trainer.train_step, trainer.ckpt.save, trainer.ckpt.wait

    def timed_step(*args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = step_fn(*args)
        end.record()
        split.append((time.perf_counter() - t0, start, end))
        return out

    saves = {"the snapshot to the host": 0.0, "the write (joined)": 0.0}

    def timed(fn, label):
        def call(*args, **kw):
            t0 = time.perf_counter()
            fn(*args, **kw)
            saves[label] += time.perf_counter() - t0
        return call

    trainer.train_step = timed_step
    trainer.ckpt.save = timed(save_fn, "the snapshot to the host")
    trainer.ckpt.wait = timed(wait_fn, "the write (joined)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with ArmSpy(router) as spy:
        t0 = time.perf_counter()
        out = trainer.run(seed=0)
        total = time.perf_counter() - t0
    counts = kernels.launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(t.numel() for _, t in tree_items(out["params"]))
    history = out["history"]
    if len(history) != TRAIN_STEPS or not all(np.isfinite(history)):
        raise AssertionError(f"train: losses {history}")
    forward = 7 * cfg.num_layers + 1  # wq wk wv wo, gate up down a layer; the head
    want = {"mm_fused": TRAIN_STEPS * (3 * forward + cfg.num_layers),
            "flash_fwd": TRAIN_STEPS * cfg.num_layers}
    got = {name: counts[name] for name in want}
    if got != want or sum(counts.values()) != sum(want.values()) or \
            sum(spy.calls.values()) != counts["mm_fused"]:
        raise AssertionError(f"train launches {counts}, predicted {want}; the arms' calls "
                             f"{sum(spy.calls.values())}")
    log(f"  {n_params} parameters; launches over {TRAIN_STEPS} steps {counts_text(got)}: "
        f"{got['mm_fused'] // TRAIN_STEPS} mm_fused a step (predicted {forward} forward + "
        f"{cfg.num_layers} silu recomputes + {2 * forward} dX/dW) and "
        f"{got['flash_fwd'] // TRAIN_STEPS} flash_fwd, as predicted")
    for arm, n in sorted(spy.calls.items(), key=lambda kv: -kv[1]):
        distinct = sum(1 for a, _ in spy.shapes if a == arm)
        log(f"    {arm_name(torch, arm)}: {n} launches, {distinct} distinct shapes")
    # the step's products at the kernels' instruction rates: tf32x3 (M > 8)
    # runs three tf32 mma.sync a step for f32 x, two for bf16 x on f32 w
    flops = instr = 0
    for ((x_dt, _, _), (m, k, n)), calls in spy.shapes.items():
        flops += calls * 2 * m * k * n
        instr += calls * 2 * m * k * n * ((3 if x_dt == torch.float32 else 2)
                                           if m > arype.SKINNY_MAX_M else 0)
    log(f"  a step's products: {flops / TRAIN_STEPS / 1e12:.4f} TFLOP, "
        f"{instr / TRAIN_STEPS / 1e12:.4f} TFLOP of tf32 mma.sync at the kernels' passes: bound "
        f"{instr / TRAIN_STEPS / TF32_OPS_PER_S * 1e3:.3f} ms a step at 495 TFLOP/s")
    walls = [t * 1e3 for t in trainer.step_times]
    for i, ((host, start, end), wall) in enumerate(zip(split, walls)):
        log(f"  step {i}: loss {history[i]:.5f}, {wall:.3f} ms (host enqueue {host * 1e3:.3f} ms, "
            f"device {start.elapsed_time(end):.3f} ms), {tokens / wall * 1e3:.1f} tokens/s")
    med = statistics.median(walls)
    dev_med = statistics.median(s.elapsed_time(e) for _, s, e in split)
    log(f"  median step {med:.3f} ms (device {dev_med:.3f} ms), {tokens / med * 1e3:.1f} "
        f"tokens/s; peak memory {peak:.2f} GB; run {total:.2f} s (init included)"
        + "; the checkpoint: " + ", ".join(f"{label} {sec:.2f} s" for label, sec in saves.items()))
    steps_saved = [d for d in sorted((TRAIN_CKPT / "full").iterdir())]
    size = sum(f.stat().st_size for d in steps_saved for f in d.iterdir()) / 1e9
    log(f"  checkpoints {[d.name for d in steps_saved]}, {size:.2f} GB; "
        f"{disk_free_gb(ROOT):.1f} GB free before deleting them")
    if [d.name for d in steps_saved] != [f"step_{TRAIN_STEPS:08d}"]:
        raise AssertionError(f"train: checkpoints {steps_saved}")
    shutil.rmtree(TRAIN_CKPT / "full")
    launches = {arm_name(torch, arm): n for arm, n in spy.calls.items()}
    if profile:
        profile_train(torch, step_fn, out["params"], out["opt_state"],
                      {k: torch.as_tensor(v).to(CARD) for k, v in trainer.pipeline.batch(0).items()},
                      med)
    trained = out["params"]
    del out, trainer
    torch.cuda.empty_cache()

    log(f"  the backward arms at the step's shapes ({tokens} rows), against the kernel called "
        "directly and the plain twin:")
    recs = check_backward_arms(torch, router, arype, cfg, gen, tokens)
    for name, rec in recs.items():
        rec["launches"] = launches.get(name, 0)
        log(f"  {name}: {rec['launches']} launches in the run; over its shapes kernel "
            f"{rec['ms']:.5f} ms, plain {rec['plain_ms']:.5f} ms, torch.matmul "
            f"{rec['library_ms']:.5f} ms, bound {rec['bound_ms']:.6f} ms ({rec['bound_by']})")

    # -- card against CPU at full width, the depth cut
    cut = cfg.replace(num_superblocks=TRAIN_CPU_SUPERBLOCKS)
    start = dict(trained, blocks=_stack_head(trained["blocks"], TRAIN_CPU_SUPERBLOCKS))
    start = tree_map(lambda t: t.detach().cpu().clone(), start)
    del trained
    torch.cuda.empty_cache()
    batch = TokenPipeline(TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                              global_batch=TRAIN_CPU_BATCH)).batch(0)
    log(f"[train {TRAIN_ARCH} card vs cpu] full width, {TRAIN_CPU_SUPERBLOCKS} of "
        f"{cfg.num_superblocks} superblocks, batch {TRAIN_CPU_BATCH} x {TRAIN_SEQ}, one train "
        "step (the loss's gradient, the clip, AdamW at 3e-4) from the trained parameters")

    def f64_sums(x, w, *, activation="none", out_dtype=None):
        """The engines' function with the f32 sums taken in f64 and rounded
        once: the same products, the sums in another order and precision."""
        acc = (x.double() @ w.double()).float()
        return apply_activation(acc, activation).to(out_dtype or x.dtype)

    def one_step(c, dev, grads=None, engine=None):
        """(loss, grads, the updated params and AdamW state) of one step on
        ``dev`` from ``start``; with ``grads`` (a host tree) the update applies
        those instead of the step's own; with ``engine`` (on the CPU) every
        routed matmul runs it."""
        p = tree_map(lambda t: t.clone().to(dev), start)
        engines = router.arype_matmul, router.vpe_matmul
        if engine is not None:
            router.arype_matmul = router.vpe_matmul = engine
        try:
            own, metrics = grads_of(p, c, {k: torch.as_tensor(v).to(dev)
                                           for k, v in batch.items()})
        finally:
            router.arype_matmul, router.vpe_matmul = engines
        opt = make_optimizer(c.optimizer, 3e-4)
        use = own if grads is None else tree_map(lambda t: t.to(dev), grads)
        p, state = opt.update(clip_by_global_norm(use, 1.0)[0], opt.init(p), p, 0)
        host = tree_map(lambda t: t.cpu(), {"grads": own, "params": p, "opt": state})
        return float(metrics["loss"]), host

    runs = {}
    for compute in ("float32", "bfloat16"):
        c = cut.replace(compute_dtype=compute)
        runs[compute, "card"] = one_step(c, CARD)
        torch.cuda.empty_cache()
        runs[compute, "cpu"] = one_step(c, "cpu")
    runs["bfloat16", "cpu f64 sums"] = one_step(cut.replace(compute_dtype="bfloat16"), "cpu",
                                                engine=f64_sums)
    (l_card, card32), (l_cpu, cpu32) = runs["float32", "card"], runs["float32", "cpu"]
    # AdamW's first step is g / (|g| + 1e-8) a value: where |g| is near 1e-8
    # the gradients' last-bit differences move the update by a share of the
    # rate, so the update is held on the card's own gradients
    _, on_card_grads = one_step(cut.replace(compute_dtype="float32"), "cpu", card32["grads"])
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    g_share, g_at = tree_share(torch, card32["grads"], cpu32["grads"])
    p_share, p_at = tree_share(torch, {"params": card32["params"], "opt": card32["opt"]},
                               {"params": on_card_grads["params"], "opt": on_card_grads["opt"]})
    e2e, e2e_at = tree_share(torch, card32["params"], cpu32["params"])
    log(f"  f32 compute: loss card {l_card:.7f} cpu {l_cpu:.7f} (rel {rel:.3e}); worst "
        f"gradient leaf {g_share:.3e} of its max|grad| ({g_at}); the CPU's AdamW on the card's "
        f"gradients: worst updated leaf {p_share:.3e} of its max|value| ({p_at}); limits "
        f"{TRAIN_LOSS_RTOL:.0e}, {TRAIN_SHARE:.0e}, {TRAIN_SHARE:.0e}; each device on its own "
        f"gradients (not held): worst parameter {e2e:.3e} ({e2e_at})")
    if not (rel <= TRAIN_LOSS_RTOL and g_share <= TRAIN_SHARE and p_share <= TRAIN_SHARE):
        raise AssertionError("train card vs cpu: f32 compute outside its tolerances")
    # bf16 compute: a one-ulp difference in an f32 sum flips a bf16 rounding
    # now and then, and the flips spread through the layers; the readings set
    # the card's distance from the CPU beside what a change of the sums'
    # order alone does on the CPU and beside the distance from f32 compute
    card16, cpu16, f64s16 = (runs["bfloat16", dev] for dev in ("card", "cpu", "cpu f64 sums"))
    readings = {"card vs cpu": (card16, cpu16),
                "cpu f64 sums vs cpu (the order alone)": (f64s16, cpu16),
                "control: card vs cpu f32 compute": (card16, runs["float32", "cpu"]),
                "control: cpu vs cpu f32 compute": (cpu16, runs["float32", "cpu"])}
    l2 = {}
    for label, ((la, a), (lb, b)) in readings.items():
        gs, gs_at = tree_share(torch, a["grads"], b["grads"])
        l2[label], med, (worst, worst_at) = tree_l2(torch, a["grads"], b["grads"])
        log(f"  bf16 compute, {label}: loss {la:.7f} against {lb:.7f} (rel "
            f"{abs(la - lb) / abs(lb):.3e}); the gradients' relative L2 {l2[label]:.3e} over "
            f"all leaves, {med:.3e} the median leaf, {worst:.3e} the worst ({worst_at}); worst "
            f"leaf by max|diff| {gs:.3e} of its max|grad| ({gs_at})")
    sound, control = l2["card vs cpu"], l2["control: card vs cpu f32 compute"]
    log(f"  bf16 compute: the gradients' relative L2, card vs cpu {sound:.3e}, limit "
        f"{TRAIN_BF16_L2:.3e} (control {control:.3e})")
    if not sound <= TRAIN_BF16_L2:
        raise AssertionError("train card vs cpu: bf16 compute outside its tolerance")
    del runs, card32, cpu32, card16, cpu16, f64s16, on_card_grads

    # -- resume at full width, the depth cut
    resume_data = TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_CPU_BATCH)

    def resume_loop(name: str, **kw) -> TrainLoopConfig:
        return TrainLoopConfig(total_steps=TRAIN_RESUME_STEPS, checkpoint_every=2,
                               log_every=10**9, checkpoint_dir=str(TRAIN_CKPT / name), **kw)

    log(f"[train {TRAIN_ARCH} resume] full width, {TRAIN_CPU_SUPERBLOCKS} superblocks, "
        f"{TRAIN_RESUME_STEPS} steps straight against a run that fails at step 3 and resumes "
        f"from its step-2 checkpoint ({disk_free_gb(ROOT):.1f} GB free)")
    straight = Trainer(cut, resume_loop("straight"), resume_data, device=CARD).run()
    shutil.rmtree(TRAIN_CKPT / "straight")
    try:
        Trainer(cut, resume_loop("resumed", fail_at_step=3), resume_data, device=CARD).run()
        raise AssertionError("train resume: the injected failure did not happen")
    except RuntimeError as e:
        log(f"  {e}")
    resumed_trainer = Trainer(cut, resume_loop("resumed"), resume_data, device=CARD)
    log(f"  restarting from step {resumed_trainer.ckpt.latest_step()}; "
        f"{disk_free_gb(ROOT):.1f} GB free before deleting the checkpoints")
    resumed = resumed_trainer.run()
    shutil.rmtree(TRAIN_CKPT)
    same_loss = resumed["history"] == straight["history"][2:]
    same = [torch.equal(a, b) for (_, a), (_, b) in zip(tree_items(straight["params"]),
                                                        tree_items(resumed["params"]))]
    log(f"  losses straight {straight['history']}, resumed {resumed['history']}; final "
        f"parameters equal bit for bit in {sum(same)} of {len(same)} leaves")
    if not (same_loss and all(same)):
        share, at = tree_share(torch, resumed["params"], straight["params"])
        raise AssertionError(f"train resume: not bit for bit (worst leaf {share:.3e} of its "
                             f"max|value| at {at})")
    del straight, resumed
    torch.cuda.empty_cache()
    return recs


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
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import layers as lm_layers
    from repro_torch.models import transformer as lm_mod
    from repro_torch.models.paper_models import cnn_apply, init_paper_model
    from repro_torch.runtime import RuntimeConfig, record_routes
    from repro_torch.serving import OctopusPipeline, PipelineConfig, ShardedOctopusPipeline

    t_start = time.perf_counter()

    def elapsed(phase: str) -> None:
        log(f"[time] {time.perf_counter() - t_start:.1f} s before phase {phase}")

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

    elapsed("2")
    # -- 2. kernels vs plain versions
    gen = torch.Generator().manual_seed(0)
    fused_q_plan = lambda m, k, n: arype.mm_fused_q_plan(m, k, n, arype.sm_count(torch.device(0)))
    # each engine kernel against its plain version at a list of shapes
    checks = {
        "vpe_mm": lambda shapes: check_matmuls(torch, vpe_matmul, vpe_mm, shapes, gen),
        "mm_fused": lambda shapes: check_matmuls(torch, arype.arype_matmul, arype.mm_fused,
                                                 shapes, gen, plan=arype.card_plan),
        "vpe_mm_q": lambda shapes: check_quant_matmuls(torch, vpe_matmul_q, vpe_mm_q, shapes,
                                                       gen, plan=vpe_q_plan),
        "mm_fused_q": lambda shapes: check_quant_matmuls(
            torch, arype.arype_matmul_q, arype.mm_fused_q, shapes, gen, plan=fused_q_plan),
    }
    log("[kernels] each kernel against its plain version on the card")
    results = {
        "flow_update": check_flow_update(torch, ff, gen),
        "vpe_mm": checks["vpe_mm"](VPE_SHAPES),
        "mm_fused": checks["mm_fused"](ARYPE_SHAPES),
        "vpe_mm_q": checks["vpe_mm_q"](VPE_SHAPES),
        "mm_fused_q": checks["mm_fused_q"](ARYPE_SHAPES),
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

    elapsed("3")
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

    elapsed("4")
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

    elapsed("5")
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

    elapsed("6")
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

    elapsed("7")
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

    elapsed("8")
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

    elapsed("9")
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

    elapsed("10")
    # -- 10. placement reports
    for label, params, pcfg in (("cnn", cnn, PIPE), ("transformer", tf, tf_pipe)):
        log(f"[plan] {label}")
        log(OctopusPipeline(mlp, params, PipelineConfig(**pcfg)).explain())

    elapsed("10b")
    # -- 10b. the measured crossover, and the CNN pipeline under it
    errs, _ = calibrate_phase(torch, ft, fx, kernels, record_routes, checks, TrafficConfig,
                              TrafficGenerator, OctopusPipeline, PipelineConfig, mlp, cnn,
                              batches, cnn_layers)
    for name, err in errs.items():
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)

    elapsed("11")
    # -- 11. the dispatch modes and the two-level flow table
    two_level_phase(torch, kernels, record_routes, cs, prefetch, TrafficConfig,
                    TrafficGenerator, OctopusPipeline, PipelineConfig, mlp, cnn, card)

    elapsed("12")
    # -- 12. masked buckets
    phase_errs = [masked_phase(torch, ff, fx, ft, kernels, record_routes, checks, TrafficConfig,
                               TrafficGenerator, OctopusPipeline, PipelineConfig, mlp, cnn, card)]

    elapsed("13")
    # -- 13. sharded lanes, one lane-batched bank
    phase_errs.append(sharded_phase(
        torch, fx, ft, kernels, record_routes, checks, TrafficConfig, TrafficGenerator,
        OctopusPipeline, ShardedOctopusPipeline, PipelineConfig, mlp, cnn, int8, card, profile))

    elapsed("14")
    # -- 14. the async serving frontend
    phase_errs.append(service_phase(
        torch, fx, build, serving, kernels, record_routes, checks, TrafficConfig,
        TrafficGenerator, OctopusPipeline, ShardedOctopusPipeline, PipelineConfig, mlp, cnn, card))
    for errs in phase_errs:
        for name, err in errs.items():
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)

    elapsed("15")
    # -- 15. LM serving: qwen3-0.6b at full width and depth
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

    elapsed("16")
    # -- 16. LM card vs CPU
    log(f"[lm card vs cpu] batch 1, a {LM_CPU_PROMPT}-token prompt, prefill + {LM_CPU_DECODES} "
        f"decode steps at full depth")
    lm_card_vs_cpu(torch, lm_mod, lm_cfg, lm_params, lm_rng)

    elapsed("17")
    # -- 17. LM serving at the registered compute dtype: bf16 activations on
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

    elapsed("18")
    # -- 18. gemma3-1b at full width, as registered
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

    elapsed("18b")
    # -- 18b. granite-moe-1b-a400m at full width and depth, as registered
    errs = granite_phase(torch, np, kernels, record_routes, lm_mod, lm_layers, serving,
                         get_config, fa, arype, vpe_matmul, vpe_mm, gen)
    for name in ("mm_fused", "vpe_mm"):
        mixed[name]["max_abs_err"] = max(mixed[name]["max_abs_err"], errs.get(name, 0.0))
    flash_bf16["max_abs_err"] = max(flash_bf16["max_abs_err"], errs["flash_fwd"])

    elapsed("18c")
    # -- 18c. starcoder2-15b at full width and depth: bf16 weights and compute
    star = starcoder_phase(torch, np, kernels, record_routes, lm_mod, serving, get_config,
                           reduced_config, fa, arype, vpe_matmul, vpe_mm, vpe_matmul_q,
                           vpe_mm_q, gen)
    for name, err in star.pop("errs").items():
        rec = (flash_bf16 if name == "flash_fwd" else star[name] if name in star
               else results[name])
        rec["max_abs_err"] = max(rec["max_abs_err"], err)

    elapsed("18d")
    # -- 18d. qwen3-4b at full width and depth, as registered
    errs = qwen4b_phase(torch, np, kernels, record_routes, lm_mod, serving, get_config, fa,
                        arype, vpe_matmul, vpe_mm, gen)
    for name in ("mm_fused", "vpe_mm"):
        mixed[name]["max_abs_err"] = max(mixed[name]["max_abs_err"], errs.get(name, 0.0))
    flash_bf16["max_abs_err"] = max(flash_bf16["max_abs_err"], errs["flash_fwd"])

    elapsed("18e")
    # -- 18e. training qwen3-0.6b at full width and depth
    train = train_phase(torch, np, kernels, get_config, arype, gen, profile)
    t_cfg = get_config(TRAIN_ARCH)
    log(f"[train {TRAIN_ARCH}] flash_fwd alone at the training step's shape (bf16, B "
        f"{TRAIN_BATCH}, S {TRAIN_SEQ}, {t_cfg.num_heads} heads over {t_cfg.num_kv_heads}, D "
        f"{t_cfg.head_dim}, causal):")
    flash_train = flash_case(torch, fa, gen, (TRAIN_BATCH, t_cfg.num_heads, t_cfg.num_kv_heads,
                                              TRAIN_SEQ, TRAIN_SEQ, t_cfg.head_dim, "causal", 0,
                                              None), "bfloat16", lm_layout=True)
    flash_bf16["max_abs_err"] = max(flash_bf16["max_abs_err"], flash_train["max_abs_err"])

    # -- 18f, 18g. the recurrent archs at full width and depth, as registered
    recurrent = {}
    for phase, arch in zip(("18f", "18g"), RECURRENT_ARCHS):
        elapsed(phase)
        recurrent[arch] = recurrent_phase(torch, np, kernels, record_routes, lm_mod, serving,
                                          get_config, fa, arype, vpe_matmul, vpe_mm, gen, arch)

    # -- 18h, 18i. the stub frontends: hubert-xlarge (audio frames, encoder-only)
    # and llama-3.2-vision-90b (image embeddings, cross attention)
    elapsed("18h")
    hubert = hubert_phase(torch, np, kernels, record_routes, lm_mod, get_config, fa, arype,
                          vpe_matmul, vpe_mm, gen)
    elapsed("18i")
    vision = vision_phase(torch, np, kernels, record_routes, lm_mod, get_config, fa, arype, gen)

    elapsed("19-21")
    # -- 19-21. the offline extractor, the per-granularity paths, the scenarios
    trace, trace_state = extractor_phase(torch, kernels, card)
    errs = paths_phase(torch, kernels, record_routes, checks, mlp, cnn, tf, trace, trace_state,
                       card)
    for name, err in errs.items():
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
    scenarios_phase(torch, kernels, record_routes, TrafficConfig, TrafficGenerator, mlp, cnn,
                    cnn_layers, card)

    elapsed("22")
    # -- 22. records
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
    # the bf16-weight arms (bf16 x, bf16 w) of mm_fused (starcoder2-15b's
    # serve) and vpe_mm (reduced starcoder2's batch-1 runs)
    source_bf16w = {"mm_fused": "src/repro_torch/csrc/mm_fused_bf16w.cu",
                    "vpe_mm": source["vpe_mm"]}
    record += [dict(name=f"{name} (bf16 x, bf16 w)", route="cuda", source=source_bf16w[name],
                    replaces=replaces[name], **r) for name, r in star.items()]
    # the arms the training backward reaches: dX (f32 cotangent on f32 w
    # into bf16) and dW and the silu recompute (bf16 x on an f32 cotangent
    # or w into f32), launches counted over [train]'s full-width run
    record += [dict(name=name, route="cuda", source=source["mm_fused"],
                    replaces=replaces["mm_fused"], **r) for name, r in train.items()]
    # flash_fwd's bf16 tensor-core kernel (the bf16 serve's prefill)
    record.append(dict(name="flash_fwd (bf16)", route="cuda", source=source["flash_fwd"],
                       replaces=replaces["flash_fwd"], **flash_bf16))
    # the recurrent archs' serves: the mixed arms at every recorded shape, and
    # zamba2's shared-attention prefill at head_dim 80, launches from each serve
    arm = {"mm_fused": "mm_fused (bf16 x, f32 w)", "vpe_mm": "vpe_mm (bf16 x, f32 w)",
           "flash_fwd": "flash_fwd (bf16, D 80)"}
    for arch, recs in recurrent.items():
        record += [dict(name=f"{arm[name]}, {arch}", route="cuda", source=source[name],
                        replaces=replaces[name], **r) for name, r in recs.items()]
    # the stub frontends: hubert's mixed arms and full-mask flash at D 80;
    # llama-vision's bf16-weight arm (the cross k/v over the image rows too)
    # and its flash calls, the cross ones at Sq 300 and 1 against 1600 keys
    arm = {"mm_fused": "mm_fused (bf16 x, f32 w)", "vpe_mm": "vpe_mm (bf16 x, f32 w)",
           "flash_fwd": "flash_fwd (bf16, D 80, full mask)"}
    record += [dict(name=f"{arm[name]}, {HUBERT_ARCH}", route="cuda", source=source[name],
                    replaces=replaces[name], **r) for name, r in hubert.items()]
    arm = {"mm_fused": ("mm_fused (bf16 x, bf16 w)", source_bf16w["mm_fused"]),
           "flash_fwd": ("flash_fwd (bf16, self and cross)", source["flash_fwd"])}
    record += [dict(name=f"{arm[name][0]}, {VISION_ARCH}", route="cuda", source=arm[name][1],
                    replaces=replaces[name], **r) for name, r in vision.items()]
    elapsed("end")
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
