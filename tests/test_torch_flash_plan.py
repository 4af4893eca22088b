"""The plan that picks how ``flash_fwd`` runs a head width (``flash_plan``) and
the arithmetic of its bf16 tensor-core kernel (``csrc/flash_fwd.cu``), on the
CPU, without a card or nvcc:

    PYTHONPATH=src python -m pytest -q tests/test_torch_flash_plan.py

The emulation follows the kernel: the scores are exact bf16 products summed
in f32 and scaled after the dot (with log2(e), for exp2), the online softmax
runs over its key tiles with masked scores at -inf, l sums the f32 p, and
P @ V takes p split into bf16 hi + lo against the bf16 V into an f32 sum.  It
is held to ``chip_smoke.py``'s unchanged ``FLASH_TOL`` against the plain twin,
and the same emulation with p rounded to bf16 alone (SDPA's function) is shown
to miss it.  The fragment checks hold the kernel's ldmatrix addresses and
register use to PTX's m16n8k16 bf16 layouts."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.ops import (
    FLASH_TILES,
    GRID_Y_MAX,
    MAX_HEAD_DIM,
    NEG_INF,
    FlashPlan,
    flash_attention_plain,
    flash_plan,
    valid_pairs,
)

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)
RTOL, ATOL = smoke.FLASH_TOL["bfloat16"]
LOG2E = 1.4426950408889634
SMEM_PER_BLOCK = 232448  # an H100 block's most shared memory (227 KB, after opting in)


def _emulated(q, k, v, *, mask, window, kv_len, split: bool) -> torch.Tensor:
    """The bf16 kernel's function on (B, H, S, D) bf16 tensors (H shared by
    q, k and v), key tile by key tile of its plan; ``split`` False rounds p
    to bf16 alone before P @ V.  Every query row is carried at once: a tile
    with no valid key of a row leaves its m, l and acc as they are, as the
    kernel's skipped tiles do."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    bk = flash_plan(d, torch.bfloat16).bk
    qf, kf, vf = q.float(), k.float(), v.float()
    scale_log2 = np.float32(1.0 / d ** 0.5) * np.float32(LOG2E)
    qpos = torch.arange(sq)[:, None]
    m = torch.full((b, h, sq, 1), NEG_INF)
    l = torch.zeros((b, h, sq, 1))
    acc = torch.zeros((b, h, sq, d))
    for k0 in range(0, sk, bk):
        kt, vt = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        valid = valid_pairs(mask, window, kv_len, qpos, torch.arange(k0, k0 + kt.shape[2])[None])
        s = (qf @ kt.transpose(-1, -2)) * float(scale_log2)
        s = torch.where(valid, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp2(s - m_new)
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        hi = p.bfloat16().float()
        pv = hi @ vt
        if split:
            pv = pv + (p - hi).bfloat16().float() @ vt
        acc = acc * alpha + pv
        m = m_new
    return (acc / torch.where(l == 0.0, 1.0, l)).bfloat16()


# (heads, sq, sk, d, mask, window, kv_len): the LM's prefill at 258 tokens
# (D 128, and gemma3-1b's D 256 in its 512-token window), D 16, local windows,
# kv_len inside a tile, and a window that leaves rows fully masked
CASES = [(16, 258, 258, 128, "causal", 0, None), (16, 258, 258, 256, "local", 512, None),
         (16, 258, 258, 16, "causal", 0, None), (8, 200, 200, 128, "local", 48, None),
         (8, 130, 190, 16, "full", 0, 77), (8, 96, 160, 256, "causal", 0, 150),
         (4, 90, 90, 128, "local", 8, 20)]


@pytest.mark.parametrize("heads,sq,sk,d,mask,window,kv_len", CASES)
def test_split_p_holds_the_tolerance_and_bf16_p_does_not(heads, sq, sk, d, mask, window, kv_len):
    """hi + lo carries p to about 2^-17 and holds FLASH_TOL["bfloat16"] (one
    bf16 step of the output) against the plain twin, fully masked rows
    exactly 0; p rounded to bf16 alone is off by up to 2^-9 of each p and
    misses it."""
    rng = np.random.default_rng(heads * sq + d)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, heads, s, d)).astype(np.float32))
               .bfloat16() for s in (sq, sk, sk))
    kv = sk if kv_len is None else kv_len
    kw = dict(mask=mask, window=window, kv_len=kv)
    ref = flash_attention_plain(q, k, v, **kw).float()
    got = _emulated(q, k, v, **kw, split=True).float()
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
    dead = ~valid_pairs(mask, window, kv, torch.arange(sq)[:, None],
                        torch.arange(sk)[None]).any(dim=1)
    assert (got[:, :, dead] == 0).all()
    alone = _emulated(q, k, v, **kw, split=False).float()
    assert not torch.allclose(alone, ref, rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------------ the plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_of_every_head_width(dtype):
    """Every D the wrapper takes (8 to 256 in steps of 8) has a tile of its
    type, wide enough, within a block's shared memory; the grid
    of the LM's largest prefill fits too."""
    for d in range(8, MAX_HEAD_DIM + 1, 8):
        plan = flash_plan(d, dtype)
        assert FLASH_TILES[plan.tile] == tuple(plan)
        assert plan.variant == ("mma" if dtype == torch.bfloat16 else "simt")
        assert d <= plan.width and (plan.width - d < 32 or plan.variant == "mma")
        assert plan.smem_bytes(d) <= SMEM_PER_BLOCK, (d, plan)
        assert plan.bq == 64
        if plan.variant == "mma":
            # a 16-deep k-step and the n8 output tiles: DP a multiple of 16,
            # whole 16-key steps of P @ V, and at most 16 bytes of padding a row
            assert plan.width % 16 == 0 and plan.bk % 16 == 0
            assert plan.width == min(t[3] for t in FLASH_TILES if t[0] == "mma" and t[3] >= d)
        gx, gy = plan.grid(4 * 16, 300)
        assert gx == 5 and gy == 64 <= GRID_Y_MAX


def test_plan_at_the_lm_widths():
    """qwen3-0.6b's D 128: 64 x 32 tiles at 52 KB (three blocks an SM, by registers);
    gemma3-1b's D 256: 64 x 32 at 99 KB (two)."""
    assert flash_plan(128, torch.bfloat16) == FlashPlan("mma", 64, 32, 128)
    assert flash_plan(128, torch.bfloat16).smem_bytes(128) == 52224
    assert flash_plan(256, torch.bfloat16) == FlashPlan("mma", 64, 32, 256)
    assert flash_plan(256, torch.bfloat16).smem_bytes(256) == 101376
    assert flash_plan(128, torch.float32) == FlashPlan("simt", 64, 32, 128)
    for d in (12, 0, 264):
        with pytest.raises(ValueError, match="multiple of 8"):
            flash_plan(d, torch.bfloat16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_plan(128, torch.float16)


# ------------------------------------------------- the m16n8k16 bf16 fragments

LANES = np.arange(32)
GID, TIG = LANES // 4, LANES % 4


def _ldmatrix(addr, trans: bool):
    """ldmatrix .x4 on 8 x 8 b16 matrices: lanes 8i..8i+7 give matrix i's
    row addresses as (row, col); register i of lane t holds that matrix's
    elements (t / 4, 2 (t % 4) + e), or with .trans (2 (t % 4) + e, t / 4),
    e = 0, 1.  Returns [register][lane][e] -> (row, col) in the tile."""
    out = []
    for i in range(4):
        rows, cols = addr(LANES[8 * i:8 * i + 8])
        reg = []
        for t in LANES:
            r, c = (2 * (t % 4), t // 4) if trans else (t // 4, 2 * (t % 4))
            reg.append([(rows[r + e], cols[r + e] + c) if trans else (rows[r], cols[r] + c + e)
                        for e in range(2)])
        out.append(reg)
    return out


def _ptx_a(i, e):
    """PTX's m16n8k16 A fragment (row-major, .bf16): a_i element e of lane t."""
    return GID + 8 * (i % 2), 2 * TIG + 8 * (i // 2) + e


def _ptx_b(i, e):
    """PTX's m16n8k16 B fragment (.col, .bf16): (k, n) of b_i element e."""
    return 2 * TIG + 8 * i + e, GID


def _ptx_c(e):
    """PTX's m16n8 f32 C/D fragment: (row, col) of c_e."""
    return GID + 8 * (e // 2), 2 * TIG + e % 2


def test_fragment_coordinates_are_ptx_layouts():
    """The kernel's ldmatrix addresses (flash_mma_kernel) give exactly PTX's
    fragments: Q's A (row warp*16 + lane % 16, column lane / 16 * 8), K's
    rows as S's .col B for key tiles j and j + 1 (row j*8 + lane % 8 +
    lane / 16 * 8, column lane / 8 % 2 * 8), V's ldmatrix.trans as P @ V's
    B for column tiles j and j + 1 (row lane % 8 + lane / 8 % 2 * 8, column
    j*8 + lane / 16 * 8); S's C fragment of key tiles 2t and 2t + 1 is P's A
    fragment of step t in the order hi[2 half + r]; the masks and the store
    read C's (row, column)."""
    q = _ldmatrix(lambda l: (l % 16, l // 16 * 8), trans=False)
    kk = _ldmatrix(lambda l: (l % 8 + l // 16 * 8, l // 8 % 2 * 8), trans=False)
    vv = _ldmatrix(lambda l: (l % 8 + l // 8 % 2 * 8, l // 16 * 8), trans=True)
    for e in range(2):
        for i in range(4):
            rows, cols = _ptx_a(i, e)
            assert [x[e] for x in q[i]] == list(zip(rows, cols)), ("Q", i, e)
        for tile in range(2):  # registers (0, 1) for tile j, (2, 3) for j + 1
            for i in range(2):
                k_, n_ = _ptx_b(i, e)
                # S = Q K^T: B[k = d][n = key] is K[key][d]; K's smem row is the key
                assert [x[e] for x in kk[2 * tile + i]] == list(zip(n_ + 8 * tile, k_)), ("K", i)
                # P @ V: B[k = key][n = d] is V[key][d]; V's smem row is the key
                assert [x[e] for x in vv[2 * tile + i]] == list(zip(k_, n_ + 8 * tile)), ("V", i)
    # hi[2 * half + r] packs s[2t + half][2r], [2r + 1]: C's (row, key) of key
    # tile 2t + half is A's (row, key) of step t
    for half in range(2):
        for r in range(2):
            for e in range(2):
                crow, ccol = _ptx_c(2 * r + e)
                arow, acol = _ptx_a(2 * half + r, e)
                assert np.array_equal(crow, arow) and np.array_equal(ccol + 8 * half, acol)
    # the kernel's mask row qi[e / 2] = w0 + gid + 8 (e / 2) and key
    # k0 + j*8 + 2 tig + e % 2, and its store of (o[j][2r], o[j][2r + 1]) at
    # row qi[r], columns j*8 + 2 tig (+1), are C's coordinates
    for e in range(4):
        crow, ccol = _ptx_c(e)
        assert np.array_equal(crow, GID + 8 * (e // 2)) and np.array_equal(ccol, 2 * TIG + e % 2)


@pytest.mark.parametrize("dp", sorted({t[3] for t in FLASH_TILES if t[0] == "mma"}))
def test_ldmatrix_rows_hit_distinct_banks(dp):
    """Shared tiles have rows of DP + 8 bf16: each ldmatrix phase (eight
    16-byte rows at one column) lands on eight distinct 16-byte bank groups,
    and every row starts 16-byte aligned for cp.async and ldmatrix."""
    stride = 2 * (dp + 8)  # bytes
    assert stride % 16 == 0
    for col in range(0, dp, 8):
        groups = {(r * stride + 2 * col) // 16 % 8 for r in range(8)}
        assert len(groups) == 8, (dp, col)


if __name__ == "__main__":
    # each case's worst error of the emulated kernel, split and bf16-alone, as
    # a share of what FLASH_TOL allows there (atol + rtol |ref|)
    for heads, sq, sk, d, mask, window, kv_len in CASES:
        rng = np.random.default_rng(heads * sq + d)
        q, k, v = (torch.from_numpy(rng.standard_normal((1, heads, s, d)).astype(np.float32))
                   .bfloat16() for s in (sq, sk, sk))
        kw = dict(mask=mask, window=window, kv_len=sk if kv_len is None else kv_len)
        ref = flash_attention_plain(q, k, v, **kw).float()
        allowed = ATOL + RTOL * ref.abs()
        shares = [((_emulated(q, k, v, **kw, split=split).float() - ref).abs() / allowed).max()
                  for split in (True, False)]
        print(f"H{heads} Sq{sq} Sk{sk} D{d} {mask} w{window} kv_len {kv_len}: hi + lo "
              f"{shares[0]:.3g} of the allowed, bf16 p alone {shares[1]:.3g}")
