"""The plans that pick how the AryPE kernels run a shape (``mm_fused_plan``,
``mm_fused_q_plan``, ``mm_unfused_plan``), and the tensor-core arithmetic of
``csrc/gemm_tiles.cuh`` and ``csrc/mm_fused_q.cu``.

These run on the CPU, without a card or nvcc:

    PYTHONPATH=src python -m pytest -q tests/test_torch_mm_fused_plan.py

The shapes are the ones ``chip_smoke.py`` checks on the card: the LM's decode,
prefill and head matmuls, the pipelines' AryPE layers, Table 6's and the
collaborative stack's.  The emulations follow the kernels' arithmetic: for
3xTF32, tf32 rounding as ``cvt.rna``, a truncating f32 sum in the 8-deep
steps of ``mma.sync``, each 32-deep K tile's sum promoted, the unfused
partials' tiles starting at each block's first K, held to ``chip_smoke.py``'s
unchanged tolerance against the plain twin; for int8, the code tiles in
shared memory, the fragments each lane's registers hold and the int32 sum of
every m16n8k32 product, held bit for bit to the plain twin; for the
bf16-activation (mixed) arm, a bf16 value's tf32 split (hi its bits, lo 0),
its fragment reads against PTX's layout and the shared-memory banks, and the
load width ``gemm_tiles.cuh:copy_width`` picks for odd K and unaligned
views.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.collaborative import usecase2_layers
from repro_torch.kernels.arype_matmul.ops import (
    GRID_Y_MAX,
    MAX_CLUSTER,
    MM_FUSED_TILES,
    SKINNY_MAX_M,
    SKINNY_STEP_ROWS,
    TF32X3_TILES,
    mm_fused,
    mm_fused_plan,
    mm_fused_q_plan,
    mm_unfused_partials_plain,
    mm_unfused_plan,
    sum_partials,
)
from repro_torch.configs import reduced_config
from repro_torch.kernels.vpe_smallmm.ops import VpePlan, vpe_mm_q, vpe_plan
from repro_torch.runtime import RuntimeConfig
from repro_torch.runtime.quant import pick_scale
from repro_torch.runtime.routing import route_matmul

ROOT = Path(__file__).resolve().parent.parent
KBK = 32  # the tf32x3 variant's K tile (csrc/mm_fused.cu kBK)


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _load("chip_smoke", ROOT / "chip_smoke.py")
# the int8 and unfused shapes the card tests run (that file imports no JAX)
card_tests = _load("card_tests", ROOT / "tests" / "test_torch_cuda.py")
LM_CFG = get_config(smoke.LM_ARCH)
SLOTS = smoke.LM_SERVE["batch_slots"]
LM_LAYER_KN = [(k, n) for _, _, k, n in smoke.lm_matmul_shapes(LM_CFG, 1)[:-1]]
LM_HEAD_KN = (LM_CFG.d_model, LM_CFG.padded_vocab)
# (k, n) pairs beyond the LM's: the pipelines', the tests' ragged ones
OTHER_KN = [(k, n) for _, _, k, n in smoke.ARYPE_SHAPES + smoke.TF_ARYPE_SHAPES] + [
    (1, 1), (5, 7), (300, 65), (301, 163), (0, 9)]


def _lm_decode_shapes():
    """Decode (one row a slot, or 1 for a single request) and the head, which
    reads that many rows in both phases."""
    shapes = []
    for rows in (1, SLOTS):
        shapes += [(rows, k, n) for k, n in LM_LAYER_KN + [LM_HEAD_KN]]
    return shapes


def _lm_prefill_shapes():
    """The layer matmuls of a prefill of S tokens, alone (M = S) and in the
    serve's slot batch (M = slots x S), over chip_smoke's prompt range."""
    lo, hi = smoke.LM_PROMPT
    return [(rows, k, n) for s in (lo, 20, 258, hi) for rows in (s, SLOTS * s)
            for k, n in LM_LAYER_KN]


@pytest.mark.parametrize("label,shapes,variant", [
    ("lm decode and head", _lm_decode_shapes(), "skinny"),
    ("lm prefill", _lm_prefill_shapes(), "tf32x3"),
    ("cnn pipeline", [s[1:] for s in smoke.ARYPE_SHAPES], "tf32x3"),
    ("transformer pipeline", [s[1:] for s in smoke.TF_ARYPE_SHAPES], "tf32x3"),
    ("table 6", [s[1:] for s in usecase2_layers(smoke.TABLE6_FLOWS)], "tf32x3"),
    ("collaborative stack", [(smoke.COLLAB_STACK[0][0], k, n)
                             for k, n in smoke.COLLAB_STACK[1:]], "tf32x3"),
])
def test_plan_variant_of_every_checked_shape(label, shapes, variant):
    assert shapes
    for m, k, n in shapes:
        assert mm_fused_plan(m, k, n).variant == variant, (label, m, k, n)


@pytest.mark.parametrize("k,n", LM_LAYER_KN + [LM_HEAD_KN] + OTHER_KN)
def test_plan_boundary_is_m_8(k, n):
    assert SKINNY_MAX_M == 8
    assert mm_fused_plan(8, k, n).variant == "skinny"
    assert mm_fused_plan(9, k, n).variant == "tf32x3"


@pytest.mark.parametrize("k,n", LM_LAYER_KN + [LM_HEAD_KN] + OTHER_KN)
def test_plan_split_and_k_order_do_not_depend_on_m(k, n):
    # skinny: the whole plan (slab, K ranks) comes from (K, N) alone
    skinny = {mm_fused_plan(m, k, n) for m in range(1, SKINNY_MAX_M + 1)}
    assert len(skinny) == 1
    # tf32x3: K is never split; its 32-deep K tiles are the kernel's constant
    for m in (9, 16, 80, 1000, 1032, 4 * 300, 5120):
        assert mm_fused_plan(m, k, n).split == 1


def test_plan_skinny_split_covers_the_sms_at_the_lm_shapes():
    """The layer matmuls launch about one CTA an SM or more, the head one K
    rank over its 1187 slabs, and no rank is shallower than one step."""
    for k, n in LM_LAYER_KN:
        plan = mm_fused_plan(SLOTS, k, n)
        gx, gy = plan.grid(SLOTS, n)
        assert gx * gy >= 128 and plan.split > 1, (k, n, plan)
        assert -(-k // plan.split) >= SKINNY_STEP_ROWS[plan.bn], (k, n, plan)
    head = mm_fused_plan(SLOTS, *LM_HEAD_KN)
    assert head.split == 1 and head.grid(SLOTS, LM_HEAD_KN[1]) == (1187, 1)


def test_plan_tf32x3_tile_balances_the_sms():
    # a 258-token prefill in 4 slots: the largest tile, 32 x 128, gives the
    # busiest SM no more output than the smaller ones
    for k, n in LM_LAYER_KN:
        assert mm_fused_plan(4 * 258, k, n)[1:3] == (32, 128), (k, n)
    # 400 rows at N = 3072: 312 CTAs of 32 x 128 put three on some SM
    assert mm_fused_plan(400, 1024, 3072)[1:3] == (32, 64)
    # a short prefill: the smallest tile spreads 96 CTAs over the SMs
    assert mm_fused_plan(80, 1024, 1024)[1:3] == (32, 32)
    # the pipelines' thin K is bound by latency: the smallest tile
    for _, m, k, n in smoke.ARYPE_SHAPES + smoke.TF_ARYPE_SHAPES:
        assert mm_fused_plan(m, k, n)[1:3] == TF32X3_TILES[-1], (m, k, n)


@pytest.mark.parametrize("sms", [114, 132, 144])
def test_plan_reads_only_the_tile_from_the_sms(sms):
    """The card's SM count moves only the tf32x3 tile: the skinny plan and
    the unsplit K stay as they are."""
    for m, k, n in _lm_decode_shapes():
        assert mm_fused_plan(m, k, n, sms=sms) == mm_fused_plan(m, k, n)
    for m, k, n in _lm_prefill_shapes():
        plan = mm_fused_plan(m, k, n, sms=sms)
        assert plan.split == 1 and (plan.bm, plan.bn) in TF32X3_TILES


def _some_shapes():
    rng = np.random.default_rng(7)
    shapes = [(int(m), int(k), int(n)) for m, k, n in zip(
        rng.integers(1, 5000, 300), rng.integers(0, 5000, 300), rng.integers(1, 200000, 300))]
    return shapes + _lm_decode_shapes() + _lm_prefill_shapes() + [(1, 1, 1), (8, 0, 3)]


def test_plan_grid_and_cluster_within_hardware_limits():
    for m, k, n in _some_shapes():
        plan = mm_fused_plan(m, k, n)
        gx, gy = plan.grid(m, n)
        assert 1 <= gx <= 2**31 - 1 and 1 <= gy <= GRID_Y_MAX, (m, k, n, plan)
        # clusters of (1, split, 1): within the portable size, tiling the grid's y
        assert 1 <= plan.split <= MAX_CLUSTER and gy % plan.split == 0, (m, k, n, plan)
        assert MM_FUSED_TILES[plan.tile] == plan[:3]
        if plan.variant == "skinny":
            assert m <= SKINNY_MAX_M and plan.bm == SKINNY_MAX_M
            assert plan.bn in SKINNY_STEP_ROWS and gy == plan.split
        else:
            assert m > SKINNY_MAX_M and plan.split == 1
            assert (plan.bm, plan.bn) in TF32X3_TILES


# ----------------------------------------------------- the VPE's plan (M <= 8)


def _vpe_shapes() -> list:
    """(label, m, k, n) of every matmul the router places on the VPE in what
    ``chip_smoke.py`` and the reduced serve tests run: the pipelines' MLP and
    conv1, the collaborative stack's, and every LM matmul (full width and
    reduced, qwen3-0.6b and gemma3-1b) at 1, 2 and 4 slots of decode (the
    head included) and at prefills of 20-300 tokens, under the collaborative
    policy; the router decides, as ``router.matmul`` asks it."""
    shapes = [(name, m, k, n) for name, m, k, n in smoke.VPE_SHAPES]
    stack = smoke.COLLAB_STACK
    shapes += [("collab", stack[0][0], k, n) for k, n in stack[1:]
               if route_matmul(stack[0][0], k, n).path == "vpe"]
    for arch in (smoke.LM_ARCH, smoke.GEMMA_ARCH):
        for cfg in (get_config(arch), reduced_config(get_config(arch))):
            rcfg = RuntimeConfig.from_arch(cfg)
            for rows in (1, 2, SLOTS, 20, 2 * 26, SLOTS * 300):
                for name, _, k, n in smoke.lm_matmul_shapes(cfg, rows):
                    m = min(rows, SLOTS) if name == "lm_head" else rows
                    if route_matmul(m, k, n, config=rcfg).path == "vpe":
                        shapes.append((f"{arch}/{name}", m, k, n))
    return shapes


def test_vpe_plan_of_every_placed_shape():
    """Every VPE matmul of the smoke config and the reduced LMs maps to the
    skinny split-K at M <= 8 (the batch-1 decode projections) and to one
    thread an output above it (the pipelines); both kinds occur."""
    shapes = _vpe_shapes()
    variants = set()
    for label, m, k, n in shapes:
        plan = vpe_plan(m, k, n)
        assert plan.variant == ("skinny" if m <= SKINNY_MAX_M else "thread"), (label, m, k, n)
        variants.add(plan.variant)
    assert variants == {"skinny", "thread"}
    # the batch-1 decode of both LMs at full width: wq, wk, wv, wo on the VPE
    one_row = {(k, n) for label, m, k, n in shapes if m == 1 and "/" in label}
    assert {(1024, 2048), (1024, 1024), (2048, 1024), (1152, 1024), (1152, 256),
            (1024, 1152)} <= one_row


def test_pipelines_keep_one_thread_an_output():
    for name, m, k, n in smoke.VPE_SHAPES:
        assert vpe_plan(m, k, n) == VpePlan("thread", 0, 1), name


@pytest.mark.parametrize("k,n", sorted({(k, n) for _, m, k, n in _vpe_shapes() if m <= 8}
                                       | set(LM_LAYER_KN) | set(OTHER_KN)))
def test_vpe_split_and_k_order_are_mm_fused_plans(k, n):
    """At M <= 8 the VPE launches the skinny kernel with mm_fused_plan's slab
    and K ranks, which come from (K, N) alone: the two engines sum in one
    order, so they give the same bits, and no row depends on M."""
    plans = {vpe_plan(m, k, n) for m in range(1, SKINNY_MAX_M + 1)}
    assert len(plans) == 1
    (plan,) = plans
    fused = mm_fused_plan(1, k, n)
    assert plan == VpePlan("skinny", fused.bn, fused.split)
    assert vpe_plan(SKINNY_MAX_M + 1, k, n).variant == "thread"


# ------------------------------------------------ why three tf32 products


def _rna_tf32(a: np.ndarray) -> np.ndarray:
    """f32 -> tf32 (10 mantissa bits) rounding to nearest, ties away from zero,
    as ``cvt.rna.tf32.f32``: add half an ulp of tf32 to the magnitude bits and
    drop the low 13."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _round_toward_zero_f32(v: np.ndarray) -> np.ndarray:
    r = v.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(v)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def _mma_emulated(x: np.ndarray, w: np.ndarray, terms, *, promote: bool) -> np.ndarray:
    """The kernel's arithmetic: at every 8-deep step of mma.sync m16n8k8, each
    (a, b) pair of ``terms`` in order adds its 8 exact products (tf32 x tf32
    fits an f32) to the tensor cores' f32 sum, which truncates (rounds toward
    zero).  With ``promote``, as the kernel does, that sum starts from 0 at
    every 32-deep K tile (``kBK``: four steps of all the terms) and is then
    added into the output's f32 sum rounding to nearest; without it the
    tensor cores carry the sum over all of K."""
    m, k = x.shape
    acc = np.zeros((m, w.shape[1]), dtype=np.float32)
    tile = np.zeros_like(acc)
    for k0 in range(0, k, 8):
        for a, b in terms:
            step = a[:, k0:k0 + 8].astype(np.float64) @ b[k0:k0 + 8].astype(np.float64)
            tile = _round_toward_zero_f32(tile.astype(np.float64) + step)
        if promote and (k0 + 8) % KBK == 0:
            acc, tile = (acc + tile).astype(np.float32), np.zeros_like(acc)
    return (acc + tile).astype(np.float32)


def _split_tf32(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    hi = _rna_tf32(v)
    return hi, _rna_tf32(v - hi)


@pytest.mark.parametrize("k", [1024, 2048, 3072])
def test_three_tf32_products_hold_the_tolerance_and_one_does_not(k):
    """3xTF32 with each 32-deep K tile's sum promoted (the kernel) holds the
    check at M = 32, a tf32x3 M; one tf32 product misses it by ~20x; without
    the promotion the truncating sum misses it at the LM's deeper K, as the
    card showed."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((32, k)).astype(np.float32)
    w = rng.standard_normal((k, 128)).astype(np.float32)
    assert mm_fused_plan(*x.shape, w.shape[1]).variant == "tf32x3"
    ref = mm_fused(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    (xh, xl), (wh, wl) = _split_tf32(x), _split_tf32(w)
    three = [(xl, wh), (xh, wl), (xh, wh)]
    rtol, atol = smoke.MATMUL_RTOL, smoke.MATMUL_RTOL * np.abs(ref).max()
    np.testing.assert_allclose(_mma_emulated(x, w, three, promote=True), ref, rtol=rtol, atol=atol)
    assert not np.allclose(_mma_emulated(x, w, [(xh, wh)], promote=True), ref, rtol=rtol, atol=atol)
    if k >= 2048:
        assert not np.allclose(_mma_emulated(x, w, three, promote=False), ref, rtol=rtol, atol=atol)
    # the split is exact where it matters: hi + lo recovers all but ~2^-22 of v
    np.testing.assert_allclose(xh.astype(np.float64) + xl, x, rtol=2.0**-21)


# ------------------------------------- the int8 and unfused kernels' plans


def int8_warp(bm: int, bn: int) -> tuple:
    """(rows, columns) of a warp of the int8 kernel's (bm, bn) tile, by
    csrc/mm_fused_q.cu with_q_tile's rule: eight warps, two down and four
    across."""
    return bm // 2, bn // 4


INT8_SHAPES = ([s[1:] for s in smoke.ARYPE_SHAPES + smoke.TF_ARYPE_SHAPES]
               + card_tests.INT8_SHAPES)


def test_int8_plan_of_every_checked_shape():
    """Every int8 shape the card checks gets a tile of the table and a grid
    within the hardware's limits; at the pipelines' thin K the smallest tile,
    so conv2 spreads over 80 CTAs where the earlier 64 x 64 tiles launched 40."""
    for bm, bn in TF32X3_TILES:
        wm, wn = int8_warp(bm, bn)
        assert wm % 16 == 0 and wn % 8 == 0 and (bm // wm) * (bn // wn) == 8, (bm, bn)
    for m, k, n in INT8_SHAPES:
        plan = mm_fused_q_plan(m, k, n)
        gx, gy, gz = plan.grid(m, n)
        assert TF32X3_TILES[plan.tile] == plan[:2] and plan.blocks == gz == 1, (m, k, n)
        assert 1 <= gx <= 2**31 - 1 and 1 <= gy <= GRID_Y_MAX, (m, k, n)
        if k <= 128:
            assert plan[:2] == TF32X3_TILES[-1], (m, k, n)
    conv2 = mm_fused_q_plan(2560, 96, 32)
    assert conv2.grid(2560, 32) == (1, 80, 1)


def _blocks_walked(plan, k: int, bk: int) -> list:
    """The K indices each CTA of the partials kernel walks, as its grid and
    K loop do: block z from z*bk to min(k - z*bk, bk) + z*bk, in 32-deep
    tiles from the block's first K."""
    walked = []
    for z in range(plan.grid(1, 1)[2]):
        kbeg = z * bk
        kend = min(k - kbeg, bk) + kbeg
        for t in range(-(-(kend - kbeg) // KBK)):
            walked += range(kbeg + t * KBK, min(kbeg + (t + 1) * KBK, kend))
    return walked


@pytest.mark.parametrize("bk", [1, 20, 32, 48, 128])
@pytest.mark.parametrize("k", [5, 96, 300])
def test_unfused_grid_covers_each_k_once(bk, k):
    for m, n in ((2560, 32), (10000, 32), (33, 163), (1, 1)):
        plan = mm_unfused_plan(m, k, n, bk)
        gx, gy, gz = plan.grid(m, n)
        assert gz == -(-k // bk) <= 65535 and 1 <= gy <= GRID_Y_MAX and gx >= 1
        assert TF32X3_TILES[plan.tile] == plan[:2]
        assert sorted(_blocks_walked(plan, k, bk)) == list(range(k)), (m, n)
        if min(bk, k) <= 128:
            assert plan[:2] == TF32X3_TILES[-1]


def _partials_emulated(x: np.ndarray, w: np.ndarray, bk: int) -> np.ndarray:
    """The partials kernel's arithmetic: each block's 3xTF32 sum in 32-deep
    tiles from l * bk, promoted, as the fused kernel sums all of K."""
    parts = []
    for k0 in range(0, x.shape[1], bk):
        xb, wb = x[:, k0:k0 + bk], w[k0:k0 + bk]
        (xh, xl), (wh, wl) = _split_tf32(xb), _split_tf32(wb)
        parts.append(_mma_emulated(xb, wb, [(xl, wh), (xh, wl), (xh, wh)], promote=True))
    return np.stack(parts)


@pytest.mark.parametrize("bk", [32, 128, 48])
def test_unfused_partials_hold_the_tolerance(bk):
    """Per-block 3xTF32 partials at the unfused loop's shapes hold the card
    check's rtol against the plain twin; at bk = 32 their left-to-right sum
    equals the fused kernel's promoted sum bit for bit."""
    rng = np.random.default_rng(bk)
    for _, m, k, n in smoke.UNFUSED_SHAPES:
        x = rng.standard_normal((m, k)).astype(np.float32)
        w = rng.standard_normal((k, n)).astype(np.float32)
        got = _partials_emulated(x, w, bk)
        ref = mm_unfused_partials_plain(torch.from_numpy(x), torch.from_numpy(w), bk=bk).numpy()
        rtol = smoke.MATMUL_RTOL
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max())
        if bk == KBK:
            (xh, xl), (wh, wl) = _split_tf32(x), _split_tf32(w)
            fused = _mma_emulated(x, w, [(xl, wh), (xh, wl), (xh, wh)], promote=True)
            summed = sum_partials(torch.from_numpy(got), "none").numpy()
            assert np.array_equal(summed, fused)


def _codes(v: np.ndarray, s) -> np.ndarray:
    """octo::quantize_code: IEEE f32 division, rint (half to even), clip."""
    q = np.rint(v.astype(np.float32) / np.asarray(s, np.float32))
    return np.clip(q, -127, 127).astype(np.int8)


def _lane_maps():
    """Where each lane's fragment elements come from and what PTX makes of
    them.  A (m16n8k32 .row): the ldmatrix.x4 address lane L gives (row L % 8
    + (L / 8) % 2 * 8, byte L / 16 * 16) and what lane l receives of matrix q
    (the row of lane 8q + l / 4, bytes l % 4 * 4..); B (.col): words tig and
    4 + tig of code row gid.  PTX's layouts: a_i at row gid + 8 ((i / 4) % 2),
    k tig * 4 + i % 4 + 16 (i >= 8); b_i at k tig * 4 + i % 4 + 16 (i >= 4),
    n gid; c_e at row gid + 8 (e / 2), col tig * 2 + e % 2."""
    lane = np.arange(32)[:, None]
    gid, tig = lane // 4, lane % 4
    i = np.arange(16)[None, :]
    q, e = i // 4, i % 4
    src = 8 * q + gid  # the lane whose address row matrix q's row gid uses
    a_src = (src % 8 + (src // 8) % 2 * 8, src // 16 * 16 + tig * 4 + e)
    a_ptx = (gid + 8 * (q % 2), tig * 4 + e + 16 * (i >= 8))
    i = np.arange(8)[None, :]
    b_src = (np.broadcast_to(gid, (32, 8)), (i // 4) * 16 + tig * 4 + i % 4)
    b_ptx = (tig * 4 + i % 4 + 16 * (i >= 4), np.broadcast_to(gid, (32, 8)))
    e = np.arange(4)[None, :]
    c_ptx = (gid + 8 * (e // 2), tig * 2 + e % 2)
    return a_src, a_ptx, b_src, b_ptx, c_ptx


def _int8_kernel_emulated(x, w, sx, sw, tile) -> np.ndarray:
    """mm_fused_q.cu's decomposition: each CTA's f32 tiles zero-filled past
    the edges, quantized into 48-byte code rows (x row-major, w transposed),
    every warp's m16n8k32 fragments gathered lane by lane, multiplied as PTX
    defines, summed in int32 over the K tiles, stored through store_tile's
    indices and dequantized."""
    (m, k), n = x.shape, w.shape[1]
    bm, bn = tile
    wm, wn = int8_warp(bm, bn)
    sw_row = np.broadcast_to(np.asarray(sw, np.float32), (n,))
    a_src, a_ptx, b_src, b_ptx, c_ptx = _lane_maps()
    out = np.full((m, n), np.nan, np.float32)
    for row0 in range(0, m, bm):
        for col0 in range(0, n, bn):
            rows, cols = min(bm, m - row0), min(bn, n - col0)
            scale = np.ones(bn, np.float32)
            scale[:cols] = sw_row[col0:col0 + cols]
            acc = {}
            for k0 in range(0, k, KBK):
                depth = min(KBK, k - k0)
                xa = np.zeros((bm, KBK), np.float32)
                xa[:rows, :depth] = x[row0:row0 + rows, k0:k0 + depth]
                wb = np.zeros((KBK, bn), np.float32)
                wb[:depth, :cols] = w[k0:k0 + depth, col0:col0 + cols]
                aq = np.zeros((bm, 48), np.int8)
                aq[:, :KBK] = _codes(xa, sx)
                bq = np.zeros((bn, 48), np.int8)
                bq[:, :KBK] = _codes(wb, scale).T
                for wm0 in range(0, bm, wm):
                    for wn0 in range(0, bn, wn):
                        for i0 in range(wm0, wm0 + wm, 16):
                            a = np.zeros((16, KBK), np.int64)
                            a[a_ptx] = aq[i0 + a_src[0], a_src[1]]
                            for j0 in range(wn0, wn0 + wn, 8):
                                b = np.zeros((KBK, 8), np.int64)
                                b[b_ptx] = bq[j0 + b_src[0], b_src[1]]
                                c = (a @ b)[c_ptx]  # (lane, e) as the registers hold it
                                acc[i0, j0] = acc.get((i0, j0), 0) + c
            for (i0, j0), c in acc.items():
                assert np.abs(c).max() < 2**31
                r = row0 + i0 + c_ptx[0]
                col = col0 + j0 + c_ptx[1]
                ok = (r < m) & (col < n)
                dq = np.float32(sx) * sw_row[col[ok]]
                out[r[ok], col[ok]] = c[ok].astype(np.float32) * dq
    return out


@pytest.mark.parametrize("m,k,n", [(37, 5, 7), (256, 128, 162)])
@pytest.mark.parametrize("tile", TF32X3_TILES)
@pytest.mark.parametrize("per_channel", [False, True], ids=["tensor", "channel"])
def test_int8_tile_decomposition_equals_the_twin(m, k, n, tile, per_channel):
    rng = np.random.default_rng(m + k + n)
    x = (rng.standard_normal((m, k)) * 3).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    sx = pick_scale(np.abs(x).max())
    sw = (tuple(pick_scale(v) for v in np.abs(w).max(0).tolist()) if per_channel
          else pick_scale(np.abs(w).max()))
    got = _int8_kernel_emulated(x, w, sx, sw, tile)
    want = vpe_mm_q(torch.from_numpy(x), torch.from_numpy(w), scale_x=sx, scale_w=sw).numpy()
    assert np.array_equal(got, want)



# ------------------------------------------- the bf16-activation (mixed) arm


def _bf16_values() -> np.ndarray:
    """Every finite bf16 value, as f32."""
    bits = np.arange(1 << 16, dtype=np.uint32)
    v = (bits << 16).view(np.float32)
    return v[np.isfinite(v)]


def test_bf16_values_are_tf32_values_with_lo_zero():
    """The mixed arm's A fragment is a bf16's bits << 16: for every finite
    bf16 value that is the f32 kernel's hi = rna_tf32(v), and its lo =
    rna_tf32(v - hi) is 0, so the f32 kernel's lo*hi product adds exact
    zeros and the two-product loop equals the three-product one on
    x.float(), bit for bit."""
    v = _bf16_values()
    hi, lo = _split_tf32(v)
    assert np.array_equal(hi.view(np.uint32), v.view(np.uint32))
    assert not lo.any()
    rng = np.random.default_rng(11)
    for m, k, n in ((32, 96, 64), (16, 300, 24)):
        x = rng.standard_normal((m, k)).astype(np.float32)
        x = (x.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)  # bf16 values
        w = rng.standard_normal((k, n)).astype(np.float32)
        (xh, xl), (wh, wl) = _split_tf32(x), _split_tf32(w)
        three = _mma_emulated(x, w, [(xl, wh), (xh, wl), (xh, wh)], promote=True)
        two = _mma_emulated(x, w, [(xh, wl), (xh, wh)], promote=True)
        assert np.array_equal(two, three)


# gemm_tiles.cuh: a bf16 A tile's row stride (kAStrideBf16) and the CTA's threads
BF16_A_STRIDE = KBK + 8
TILE_THREADS = 128


def test_bf16_a_fragment_reads_are_ptx_layout_and_free_of_bank_conflicts():
    """tf32x3_sum's bf16 fragment: lane (gid, tig) reads rows gid and gid + 8,
    columns tig and tig + 4 of the 80-byte rows, which is PTX's m16n8k8 .tf32
    A layout (a0 (gid, tig), a1 (gid + 8, tig), a2 (gid, tig + 4), a3 (gid +
    8, tig + 4)); each read's 32 lanes touch distinct banks or share a word."""
    lane = np.arange(32)
    gid, tig = lane // 4, lane % 4
    reads = [(gid, tig), (gid + 8, tig), (gid, tig + 4), (gid + 8, tig + 4)]
    ptx = [(gid + 8 * (e % 2), tig + 4 * (e // 2)) for e in range(4)]
    for (r, c), (pr, pc) in zip(reads, ptx):
        assert np.array_equal(r, pr) and np.array_equal(c, pc)
        word = (r * BF16_A_STRIDE + c) * 2 // 4
        for bank in range(32):
            assert len(set(word[word % 32 == bank])) <= 1, bank


def _copy_width(base: int, k: int, elem: int) -> int:
    """gemm_tiles.cuh:copy_width: 16-byte copies where the row bytes and the
    base are 16-byte aligned, else 4 where they are 4-byte aligned, else one
    element (bf16's synchronous loads)."""
    row = k * elem
    if row % 16 == 0 and base % 16 == 0:
        return 16
    if row % 4 == 0 and base % 4 == 0:
        return 4
    return elem


def _a_copies(k: int, k0: int, copy: int, elem: int = 2, bm: int = 32):
    """load_tiles' copies of one bm x 32 A tile at K offset k0: (row, col,
    elements, in range) for every thread and step, with a thread's column
    fixed across its steps."""
    per = copy // elem
    across = KBK // per
    rows_a_step = TILE_THREADS // across
    out = []
    for tid in range(TILE_THREADS):
        r, c = tid // across, tid % across * per
        for j in range(bm // rows_a_step):
            out.append((r + j * rows_a_step, c, per, k0 + c < k))
    return out


# (k, base offset in bf16 elements): aligned, odd K, even K with a 4- but not
# 16-byte row, and views one or two elements into their storage
COPY_CASES = [(1024, 0), (300, 0), (301, 0), (5, 0), (1024, 1), (1024, 2), (6, 8), (128, 3)]


@pytest.mark.parametrize("k,offset", COPY_CASES)
def test_bf16_load_pick_keeps_every_copy_aligned_and_whole(k, offset):
    """The pick of copy_width for a bf16 x: every copy of every A tile starts
    on a multiple of its size in device memory (the row's start from the
    view's base) and in the padded shared tile, lies all inside K or all
    outside it (zero-filled), and the copies cover the tile once.  Odd K and
    2-byte-aligned views take the synchronous 2-byte loads: any cp.async
    there would split an element pair or start off its size."""
    base = 256 + 2 * offset  # a storage allocation is 256-byte aligned
    copy = _copy_width(base, k, 2)
    if k % 2 or offset % 2:
        assert copy == 2
    elif k % 8 == 0 and offset % 8 == 0:
        assert copy == 16
    else:
        assert copy == 4
    for k0 in range(0, k, KBK):
        copies = _a_copies(k, k0, copy)
        covered = sorted((r, c + e) for r, c, n, _ in copies for e in range(n))
        assert covered == [(r, c) for r in range(32) for c in range(KBK)]
        for r, c, n, ok in copies:
            assert (r * BF16_A_STRIDE + c) * 2 % copy == 0  # shared address
            if ok:
                assert (base + 2 * (r * k + k0 + c)) % copy == 0  # device address
                assert k0 + c + n <= k  # all in
    # wider copies would break one of those rules exactly where the pick refuses them
    for wider in (16, 4):
        if wider > copy:
            bad = [(base + 2 * (r * k + c)) % wider or c + n > k
                   for r, c, n, ok in _a_copies(k, 0, wider) if ok]
            assert any(bad), wider

if __name__ == "__main__":
    # the emulation's worst error at the LM's K, as a share of max|ref| and of
    # what the check allows (atol + rtol |ref|)
    for k in (1024, 2048, 3072):
        rng = np.random.default_rng(k)
        x = rng.standard_normal((32, k)).astype(np.float32)
        w = rng.standard_normal((k, 128)).astype(np.float32)
        ref = mm_fused(torch.from_numpy(x), torch.from_numpy(w)).numpy()
        (xh, xl), (wh, wl) = _split_tf32(x), _split_tf32(w)
        top = np.abs(ref).max()
        for label, terms, promote in (("3xTF32", [(xl, wh), (xh, wl), (xh, wh)], True),
                                      ("1xTF32", [(xh, wh)], True),
                                      ("3xTF32 unpromoted", [(xl, wh), (xh, wl), (xh, wh)], False)):
            err = np.abs(_mma_emulated(x, w, terms, promote=promote) - ref)
            allowed = smoke.MATMUL_RTOL * (top + np.abs(ref))
            print(f"K={k} {label}: max err / max|ref| {err.max() / top:.3g}, "
                  f"of the allowed {(err / allowed).max():.3g}")
