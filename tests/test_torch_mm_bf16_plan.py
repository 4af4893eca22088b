"""``mm_fused``'s wgmma variant (``csrc/mm_fused_wgmma.cu``): bf16 x on bf16 w
at M > 8 on Hopper's bf16 tensor cores.  Which shapes and operands its plan
sends there, that its tiles fit the card, and its sum emulated in numpy: k16
steps whose f32 sums truncate, each 64-deep K tile's sum promoted with one
round-to-nearest add.

These run on the CPU, without a card or nvcc:

    PYTHONPATH=src python -m pytest -q tests/test_torch_mm_bf16_plan.py

The shapes are the prefills ``chip_smoke.py`` serves on bf16 weights:
starcoder2-15b's and llama-3.2-vision-90b's, from their registered configs.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.arype_matmul.ops import (
    GRID_Y_MAX,
    MM_FUSED_TILES,
    SKINNY_MAX_M,
    TF32X3_TILES,
    WGMMA_TILES,
    mm_fused,
    mm_fused_plan,
    operand_plan,
)
from test_torch_mm_fused_plan import KBK, OTHER_KN, _rna_tf32, _round_toward_zero_f32, smoke

BF16 = torch.bfloat16
SMEM_PER_BLOCK = 232448  # the H100's shared memory a block can use
STEP = 16  # the K of one wgmma
# csrc/mm_fused_wgmma.cu's K tile (the K order of every output: 64-deep
# tiles of four k16 steps, each tile's sum promoted) and TMA ring depth
WGMMA_BK = 64
WGMMA_STAGES = 5


def wgmma_smem_bytes(bm: int, bn: int) -> int:
    """The kernel's dynamic shared memory (WgTile::kSmem): the ring of bf16 x
    and w tiles, 1024 bytes to align it, a full and an empty barrier a
    stage."""
    return WGMMA_STAGES * 2 * WGMMA_BK * (bm + bn) + 1024 + 2 * WGMMA_STAGES * 8


def wgmma_threads(bm: int) -> int:
    """A consumer warpgroup of 128 threads a 64 rows, one producer."""
    return (bm // 64 + 1) * 128


def _bf16_plan(m, k, n, aligned=True, **kw):
    return mm_fused_plan(m, k, n, x_dtype=BF16, w_dtype=BF16, aligned=aligned, **kw)


def _prefill_shapes(arch: str, prompts, slots: int, image_rows=()) -> list:
    """(name, m, k, n) of every routed matmul of a prefill of each prompt
    length, alone (M = S) and in the serve's slots (M = slots x S), the
    head aside (it reads the slots' last rows: M <= 8); with ``image_rows``
    the cross layers' k and v over that many image rows too."""
    cfg = get_config(arch)
    kn = sorted({(name, k, n) for name, k, n in smoke.lm_forward_matmuls(cfg)
                 if name != "lm_head"})
    shapes = [(name, rows, k, n) for s in prompts for rows in (s, slots * s)
              for name, k, n in kn]
    d = cfg.d_model
    shapes += [(f"cross {name}", rows, d, cfg.kv_dim) for rows in image_rows
               for name in ("wk", "wv")]
    return shapes


STAR_SHAPES = _prefill_shapes(smoke.STAR_ARCH, smoke.STAR_PROMPTS,
                              smoke.STAR_SERVE["batch_slots"])
_VISION = get_config(smoke.VISION_ARCH)
VISION_SHAPES = _prefill_shapes(
    smoke.VISION_ARCH, (smoke.VISION_PROMPT,), smoke.VISION_REQUESTS,
    (_VISION.num_image_tokens, smoke.VISION_REQUESTS * _VISION.num_image_tokens))


@pytest.mark.parametrize("label,shapes", [("starcoder2-15b", STAR_SHAPES),
                                          ("llama-3.2-vision-90b", VISION_SHAPES)])
def test_every_served_bf16_prefill_takes_wgmma(label, shapes):
    """Every prefill matmul of the two bf16-weight models: bf16 x, bf16 w,
    K and N multiples of 8 and aligned bases, so the wgmma variant, with 64
    rows a tile up to M 64 and 128 past it.  The served K reach 28672."""
    assert len(shapes) >= 12
    for name, m, k, n in shapes:
        plan = _bf16_plan(m, k, n)
        assert plan.variant == "wgmma" and plan.split == 1, (label, name, m, k, n)
        assert plan.bm == (64 if m <= 64 else 128), (label, name, m)
        assert (plan.bm, plan.bn) in WGMMA_TILES
    assert max(k for _, _, k, _ in STAR_SHAPES + VISION_SHAPES) == 28672


def test_prefill_columns_balance_the_sms():
    """BN as the busiest SM rules it: the narrow k/v projections of a
    1200-row prefill take 64 columns (80 CTAs where 128 would give 40), the
    wide ones 128 (a tie in output per SM); a 45-row prefill 64 (96 CTAs
    where 128 would leave 84 SMs idle)."""
    assert _bf16_plan(1200, 6144, 512)[1:3] == (128, 64)
    assert _bf16_plan(1200, 6144, 6144)[1:3] == (128, 128)
    assert _bf16_plan(1200, 6144, 24576)[1:3] == (128, 128)
    assert _bf16_plan(45, 6144, 6144)[1:3] == (64, 64)


def _other_shapes():
    lo, hi = smoke.LM_PROMPT
    shapes = [(m, k, n) for _, m, k, n in STAR_SHAPES + VISION_SHAPES]
    shapes += [(m, k, n) for m in (9, 65, 1200) for k, n in OTHER_KN]
    return shapes + [(m, 1024, 3072) for m in (1, 4, 8, lo, 4 * hi)]


@pytest.mark.parametrize("xt,wt", [(torch.float32, torch.float32), (BF16, torch.float32),
                                   (torch.float32, BF16)], ids=["f32", "bf16x", "bf16w"])
def test_other_type_pairs_keep_their_plan(xt, wt):
    """f32 and the mixed arms keep today's plan, aligned or not: the one the
    shape alone gives."""
    for m, k, n in _other_shapes():
        for aligned in (True, False):
            assert mm_fused_plan(m, k, n, x_dtype=xt, w_dtype=wt, aligned=aligned) \
                == mm_fused_plan(m, k, n), (m, k, n, aligned)


@pytest.mark.parametrize("m,k,n,aligned,why", [
    (40, 301, 1024, True, "odd K"), (40, 1028, 1024, True, "K not a multiple of 8"),
    (40, 1024, 163, True, "N not a multiple of 8"), (40, 1024, 1026, True, "N 2 mod 8"),
    (1200, 6144, 512, False, "an unaligned base"), (40, 0, 64, True, "K 0"),
    (8, 6144, 6144, True, "M 8: skinny"), (1, 6144, 49152, True, "M 1: skinny")])
def test_bf16_operands_tma_cannot_load_keep_their_plan(m, k, n, aligned, why):
    """bf16 x bf16 where TMA cannot take the operands (or M <= 8) keeps the
    tf32x3 or skinny plan the shape gives."""
    assert _bf16_plan(m, k, n, aligned) == mm_fused_plan(m, k, n), why


def test_operand_plan_reads_types_and_bases():
    x = torch.zeros(40, 72, dtype=BF16)
    w = torch.zeros(72 * 64 + 8, dtype=BF16)
    assert operand_plan(x, w[:72 * 64].view(72, 64)).variant == "wgmma"
    assert operand_plan(x, w[8:].view(72, 64)).variant == "wgmma"  # 16 bytes in
    assert operand_plan(x, w[1:72 * 64 + 1].view(72, 64)).variant == "tf32x3"  # 2 bytes in
    assert operand_plan(x.float(), w[:72 * 64].view(72, 64)).variant == "tf32x3"
    assert operand_plan(x[:8], w[:72 * 64].view(72, 64)).variant == "skinny"


def _random_bf16_shapes():
    rng = np.random.default_rng(31)
    shapes = [(int(m), 8 * int(k), 8 * int(n)) for m, k, n in zip(
        rng.integers(9, 200000, 300), rng.integers(1, 4000, 300), rng.integers(1, 30000, 300))]
    return shapes + [(m, k, n) for _, m, k, n in STAR_SHAPES + VISION_SHAPES] + [
        (9, 8, 8), (65, 8, 64), (2**22, 8, 8), (9, 8, 64 * 65535)]


def test_wgmma_tile_and_grid_within_hardware_limits():
    """Every wgmma plan: a tile of the table, a grid within the card's (row
    tiles on x, column tiles on y), the ring within a block's shared
    memory, at most 1024 threads, and two register sets of BN / 2 f32 a
    consumer thread within setmaxnreg's 232."""
    for bm, bn in WGMMA_TILES:
        assert bm % 64 == 0 and bn % 64 == 0
        assert wgmma_smem_bytes(bm, bn) <= SMEM_PER_BLOCK and wgmma_threads(bm) <= 1024
        assert 2 * bn // 2 + 32 <= 232
    for m, k, n in _random_bf16_shapes():
        plan = _bf16_plan(m, k, n)
        gx, gy = plan.grid(m, n)
        assert plan.variant == "wgmma" and MM_FUSED_TILES[plan.tile] == plan[:3], (m, k, n)
        assert 1 <= gx <= 2**31 - 1 and 1 <= gy <= GRID_Y_MAX, (m, k, n, plan)
        assert gx == -(-m // plan.bm) and gy == -(-n // plan.bn)


@pytest.mark.parametrize("sms", [114, 132, 144])
def test_wgmma_k_order_does_not_depend_on_m_or_the_tile(sms):
    """K is never split and its order is the kernel's constant, whatever M,
    the tile or the card; only the tile moves with M and the SMs."""
    for k, n in ((6144, 512), (6144, 6144), (8192, 28672), (72, 264)):
        plans = {_bf16_plan(m, k, n, sms=sms) for m in (9, 33, 64, 65, 200, 1032, 1200, 5120)}
        assert {p.split for p in plans} == {1} and {p.variant for p in plans} == {"wgmma"}
        assert {p.bm for p in plans} == {64, 128}
    assert WGMMA_BK == 64 and WGMMA_BK % STEP == 0 and WGMMA_BK % KBK == 0


# ------------------------------------------------------- the sum, emulated


def _bf16_values(a: np.ndarray) -> np.ndarray:
    """a rounded to bf16 (to nearest even), as f32."""
    return torch.from_numpy(a).to(BF16).float().numpy()


def _wgmma_emulated(x: np.ndarray, w: np.ndarray, *, promote: bool = True) -> np.ndarray:
    """The wgmma variant's arithmetic on bf16 values: at every k16 step the
    16 exact products (bf16 x bf16 fits an f32) add to the tensor cores' f32
    sum, which truncates (rounds toward zero), as ``_mma_emulated`` models
    ``mma.sync``.  With ``promote``, as the kernel does, that sum starts from
    0 at every 64-deep K tile (scale-d 0 on its first step) and is then added
    into the output's f32 sum rounding to nearest; a ragged last tile's
    zero-filled steps add exact zeros.  Without it the tensor cores carry
    the sum over all of K."""
    m, k = x.shape
    acc = np.zeros((m, w.shape[1]), dtype=np.float32)
    tile = np.zeros_like(acc)
    for k0 in range(0, k, STEP):
        step = x[:, k0:k0 + STEP].astype(np.float64) @ w[k0:k0 + STEP].astype(np.float64)
        tile = _round_toward_zero_f32((0.0 if promote and k0 % WGMMA_BK == 0 else
                                       tile.astype(np.float64)) + step)
        if promote and ((k0 + STEP) % WGMMA_BK == 0 or k0 + STEP >= k):
            acc = (acc + tile).astype(np.float32)
    return acc if promote else tile


def _tf32x3_bf16_emulated(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """The tf32x3 variant on bf16 x bf16 (and the f32 arm on the upcast
    operands, bit for bit): one tf32 product an 8-deep step, its truncating
    sum promoted every 32-deep K tile."""
    m, k = x.shape
    acc = np.zeros((m, w.shape[1]), dtype=np.float32)
    tile = np.zeros_like(acc)
    for k0 in range(0, k, 8):
        step = x[:, k0:k0 + 8].astype(np.float64) @ w[k0:k0 + 8].astype(np.float64)
        tile = _round_toward_zero_f32(tile.astype(np.float64) + step)
        if (k0 + 8) % KBK == 0:
            acc, tile = (acc + tile).astype(np.float32), np.zeros_like(acc)
    return (acc + tile).astype(np.float32)


def _operands(k: int, m: int = 16, n: int = 64, seed: int = 0):
    rng = np.random.default_rng(seed + k)
    x = _bf16_values(rng.standard_normal((m, k)).astype(np.float32))
    w = _bf16_values(rng.standard_normal((k, n)).astype(np.float32))
    return x, w


# whether each K's sum carried in the tensor cores over all of K, unpromoted,
# holds the check (K 6144 and 8192 are the heads' f32-out depths)
UNPROMOTED_HOLDS = {6144: True, 8192: True, 24576: False, 28672: False}


@pytest.mark.parametrize("k", [6144, 8192, 24576, 28672])
def test_promoted_k16_sum_holds_the_tolerance_at_the_served_depths(k):
    """f32 out at each served depth: the emulated kernel holds
    ``chip_smoke.MATMUL_RTOL`` (plus that of max|ref|) against the plain
    twin, and its largest error from the exact product is at most twice the
    tf32x3 arm's (the bound the card holds it to).  The same sum carried
    unpromoted over all of K holds the check or misses it as recorded in
    ``UNPROMOTED_HOLDS``."""
    x, w = _operands(k)
    assert _bf16_plan(*x.shape, w.shape[1]).variant == "wgmma"
    ref = mm_fused(torch.from_numpy(x).to(BF16), torch.from_numpy(w).to(BF16),
                   out_dtype=torch.float32).numpy()
    exact = x.astype(np.float64) @ w.astype(np.float64)
    rtol, atol = smoke.MATMUL_RTOL, smoke.MATMUL_RTOL * np.abs(ref).max()
    got = _wgmma_emulated(x, w)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)
    assert np.abs(got - exact).max() <= 2 * np.abs(_tf32x3_bf16_emulated(x, w) - exact).max()
    unpromoted = _wgmma_emulated(x, w, promote=False)
    assert np.allclose(unpromoted, ref, rtol=rtol, atol=atol) == UNPROMOTED_HOLDS[k]


@pytest.mark.parametrize("k", [72, 6144 + 8, 8192])
def test_bf16_out_within_one_step_of_the_exact_product(k):
    """bf16 out: the emulated f32 sum rounded once to nearest even lies
    within one bf16 step of the exact product."""
    x, w = _operands(k, m=24, n=40, seed=1)
    got = torch.from_numpy(_wgmma_emulated(x, w)).to(BF16).double()
    exact = torch.from_numpy(x.astype(np.float64) @ w.astype(np.float64))
    step = torch.exp2(torch.floor(torch.log2(exact.abs().clamp_min(2.0**-126))) - 7)
    assert ((got - exact).abs() <= step).all()


def _tiled_emulated(x: np.ndarray, w: np.ndarray, bm: int, bn: int) -> np.ndarray:
    """The kernel's decomposition: each CTA's tile of x and w zero-filled
    past M, N and K to whole TMA boxes (bm x 64 of x, 64 x 64 of w), summed
    by ``_wgmma_emulated`` over whole K tiles, stored masked."""
    (m, k), n = x.shape, w.shape[1]
    kp = -(-k // WGMMA_BK) * WGMMA_BK
    out = np.full((m, n), np.nan, np.float32)
    for row0 in range(0, m, bm):
        for col0 in range(0, n, bn):
            xa = np.zeros((bm, kp), np.float32)
            xa[:min(bm, m - row0), :k] = x[row0:row0 + bm]
            wb = np.zeros((kp, bn), np.float32)
            wb[:k, :min(bn, n - col0)] = w[:, col0:col0 + bn]
            tile = _wgmma_emulated(xa, wb)
            out[row0:row0 + bm, col0:col0 + bn] = tile[:min(bm, m - row0), :min(bn, n - col0)]
    return out


def test_rows_do_not_depend_on_m_or_the_tile():
    """A row's bits are the same at M 65, 200 and 1032 and under each of
    the plans' tiles, ragged M, N and K zero-filled as TMA fills them."""
    x, w = _operands(200, m=1032, n=72, seed=2)
    want = _wgmma_emulated(x[:9], w)
    for m in (65, 200, 1032):
        plan = _bf16_plan(m, 200, 72)
        assert plan.variant == "wgmma"
        for bm, bn in {plan[1:3], *WGMMA_TILES}:
            got = _tiled_emulated(x[:m], w, bm, bn)
            assert np.array_equal(got[:9], want), (m, bm, bn)
    assert not np.array_equal(_tf32x3_bf16_emulated(x[:9], w), want)  # another order


def test_tf32_emulation_is_the_tf32x3_arm_on_bf16():
    """The tf32x3 emulation above is the f32 arm's on bf16 values: their
    tf32 rounding is exact, so one product a step is the three."""
    x, w = _operands(96, m=8, n=16, seed=3)
    assert np.array_equal(_rna_tf32(x), x) and np.array_equal(_rna_tf32(w), w)
    assert set(TF32X3_TILES) <= {t[1:] for t in MM_FUSED_TILES} and SKINNY_MAX_M == 8


if __name__ == "__main__":
    # each depth's worst errors from the exact product, and against the check
    for k in (6144, 8192, 24576, 28672):
        x, w = _operands(k)
        ref = mm_fused(torch.from_numpy(x).to(BF16), torch.from_numpy(w).to(BF16),
                       out_dtype=torch.float32).numpy()
        exact = x.astype(np.float64) @ w.astype(np.float64)
        allowed = smoke.MATMUL_RTOL * (np.abs(ref).max() + np.abs(ref))
        for label, got in (("wgmma", _wgmma_emulated(x, w)),
                           ("wgmma unpromoted", _wgmma_emulated(x, w, promote=False)),
                           ("tf32x3", _tf32x3_bf16_emulated(x, w))):
            print(f"K={k} {label}: max err from exact {np.abs(got - exact).max():.3e}, of the "
                  f"allowed {(np.abs(got - ref) / allowed).max():.3g}")
