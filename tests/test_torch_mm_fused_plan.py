"""``mm_fused_plan``, the one place that picks how the ``mm_fused`` kernel runs
a shape, and why its tensor-core variant takes three tf32 products a term.

These run on the CPU, without a card or nvcc:

    PYTHONPATH=src python -m pytest -q tests/test_torch_mm_fused_plan.py

The shapes are the ones ``chip_smoke.py`` checks on the card: the LM's decode,
prefill and head matmuls, the pipelines' AryPE layers, Table 6's and the
collaborative stack's.  The last tests emulate the kernel's arithmetic (tf32
rounding as ``cvt.rna``, a truncating f32 sum in the 8-deep steps of
``mma.sync``, each 32-deep K tile's sum promoted) and hold it to ``chip_smoke.py``'s
unchanged tolerance against the plain twin.
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
)

ROOT = Path(__file__).resolve().parent.parent
KBK = 32  # the tf32x3 variant's K tile (csrc/mm_fused.cu kBK)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _chip_smoke()
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
