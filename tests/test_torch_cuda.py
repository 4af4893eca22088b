"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc; on a host without them each
one skips.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor the JAX package, so it runs where only the
port is installed."""
import itertools

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import flow_tracker as ft
from repro_torch.core.collaborative import collaborative_forward, plan_stack, usecase2_layers
from repro_torch.core.feature_extractor import packet_meta_features
from repro_torch.data.traffic import TrafficConfig, TrafficGenerator
from repro_torch.common.tree import tree_items, tree_leaves, tree_map
from repro_torch.common.util import DTYPES
from repro_torch.kernels.arype_matmul.ops import (
    MM_FUSED,
    MM_FUSED_Q,
    arype_matmul,
    arype_matmul_q,
    arype_matmul_unfused,
    mm_fused,
    operand_plan,
    mm_fused_q,
    mm_fused_q_plan,
    mm_unfused,
    mm_unfused_partials,
    mm_unfused_partials_plain,
)
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.kernels.flash_attention.ops import valid_pairs
from repro_torch.kernels.flow_features import ops as ff
from repro_torch.kernels.build import stream_of
from repro_torch.kernels.vpe_smallmm.ops import (
    VPE_MM,
    VPE_MM_Q,
    scale_row,
    vpe_matmul,
    vpe_matmul_q,
    vpe_mm,
    vpe_mm_q,
    vpe_plan,
    vpe_q_plan,
)
from repro_torch.launch.calibrate import calibrate_quant_scales
from repro_torch.models.paper_models import init_paper_model
from repro_torch.runtime import RuntimeConfig, record_routes
from repro_torch.runtime.quant import pick_scale
from repro_torch.models.transformer import LM
from repro_torch.serving import OctopusPipeline, PipelineConfig, Request, ServeConfig, ServeEngine

pytestmark = pytest.mark.cuda
# the transformer flow engine's AryPE matmuls at 256 drained rows of 15
# packets: wq/wk/wv, mlp1, mlp2, cls
TF_SHAPES = [(3840, 16, 64), (3840, 64, 128), (3840, 128, 64), (256, 64, 162)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (k, n) of the qwen3-0.6b layer matmuls mm_fused runs: wq, wk (= wv), wo,
# wi_gate (= wi_up), wo_mlp
LM_KN = [(1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072), (3072, 1024)]
LM_HEAD = (4, 1024, 151936)
MATMUL_SHAPES = [(1, 1, 1), (37, 5, 7), (1024, 6, 12), (5120, 3, 32), (2560, 96, 32),
                 (129, 300, 65), (256, 128, 162)] + TF_SHAPES
# mm_fused alone: the LM's shapes on both sides of the skinny/tf32x3 boundary
# (M 8/9), its prefill (M 1032), the head, and ragged N and K on both variants
MM_FUSED_SHAPES = ([(m, k, n) for m in (1, 4, 8, 9, 1032) for k, n in LM_KN] + [LM_HEAD]
                   + [(3, 301, 163), (8, 257, 130), (9, 301, 163), (77, 1027, 258)])


@pytest.mark.parametrize("engine,plain,m,k,n",
                         [(e, p, *s) for e, p in ((vpe_matmul, vpe_mm), (arype_matmul, mm_fused))
                          for s in MATMUL_SHAPES]
                         + [(arype_matmul, mm_fused, *s) for s in MM_FUSED_SHAPES])
@pytest.mark.parametrize("act", ["none", "relu", "silu", "gelu"])
def test_matmul_kernels_match_plain(cuda, engine, plain, m, k, n, act):
    gen = torch.Generator().manual_seed(m + k + n)
    x = torch.randn(m, k, generator=gen).to(cuda)
    w = torch.randn(k, n, generator=gen).to(cuda)
    before = kernels.launches()
    out = engine(x, w, activation=act)
    ref = plain(x, w, activation=act)
    assert sum(kernels.launches().values()) == sum(before.values()) + 1
    # only the order of the f32 sums differs
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5 * ref.abs().max().item())


@pytest.mark.parametrize("m,k,n", [(4, 1024, 1024), (4, 1024, 3072), LM_HEAD, (1032, 1024, 1024),
                                   (2560, 96, 32), (129, 300, 65)])
def test_mm_fused_is_deterministic(cuda, m, k, n):
    """Two calls give the same bits: every sum, the skinny variant's cluster
    reduction included, runs in a fixed order."""
    gen = torch.Generator().manual_seed(m * k + n)
    x = torch.randn(m, k, generator=gen).to(cuda)
    w = torch.randn(k, n, generator=gen).to(cuda)
    assert torch.equal(arype_matmul(x, w, activation="silu"), arype_matmul(x, w, activation="silu"))


@pytest.mark.parametrize("k,n", LM_KN + [LM_HEAD[1:], (301, 163)])
@pytest.mark.parametrize("rows", [1, 20], ids=["decode", "prefill"])
def test_mm_fused_rows_do_not_depend_on_m(cuda, k, n, rows):
    """Row r of a 4-slot call equals the call on that slot's rows alone, bit
    for bit: M = 4 against M = 1 (skinny), M = 80 against M = 20 (tf32x3), as
    a served request must decode like its single-request run.  Each slot's
    rows are a view at an offset, which may take the 4-byte loads."""
    gen = torch.Generator().manual_seed(k + n + rows)
    x = torch.randn(4 * rows, k, generator=gen).to(cuda)
    w = torch.randn(k, n, generator=gen).to(cuda)
    out = arype_matmul(x, w)
    for s in range(4):
        part = x[s * rows:(s + 1) * rows]
        assert torch.equal(arype_matmul(part, w), out[s * rows:(s + 1) * rows]), s


# the mixed arm (bf16 x, f32 w): the LM's shapes, ragged N and odd K on both
# variants, and K 6 (rows of 12 bytes: 4-byte copies) on the tf32x3 one
MIXED_SHAPES = MM_FUSED_SHAPES + [(3, 7, 9), (33, 301, 65), (40, 6, 130), (129, 5, 7)]
OUTS = {"bf16": torch.bfloat16, "f32": torch.float32}


def _bf16(gen, *shape):
    return torch.randn(*shape, generator=gen).to(torch.bfloat16)


@pytest.mark.parametrize("m,k,n", MIXED_SHAPES)
@pytest.mark.parametrize("act", ["none", "relu", "silu", "gelu"])
@pytest.mark.parametrize("out", list(OUTS))
def test_mixed_arm_equals_the_f32_kernel_on_upcast_x(cuda, m, k, n, act, out):
    """bf16 x on f32 w: one launch, bit for bit the f32 kernel on x.float()
    rounded once to the output type (both variants: a bf16 value is a tf32
    value with lo = 0), and within one bf16 step of the plain twin."""
    gen = torch.Generator().manual_seed(m * 3 + k + n)
    x, w = _bf16(gen, m, k).to(cuda), torch.randn(k, n, generator=gen).to(cuda)
    before = kernels.launches()
    got = arype_matmul(x, w, activation=act, out_dtype=OUTS[out])
    after = kernels.launches()
    assert after["mm_fused"] == before["mm_fused"] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    assert got.dtype == OUTS[out]
    assert torch.equal(got, arype_matmul(x.float(), w, activation=act).to(OUTS[out]))
    ref = mm_fused(x, w, activation=act, out_dtype=OUTS[out]).float()
    step = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0**-126))) - 7)
    if out == "f32":
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * ref.abs().max().item())
    else:
        assert ((got.float() - ref).abs() <= step + 1e-6 * ref.abs().max()).all()


@pytest.mark.parametrize("m,k,n", [(4, 1024, 1024), (37, 96, 65), (129, 300, 163), (9, 301, 7),
                                   (1032, 1024, 1024)])
@pytest.mark.parametrize("offset", [1, 2, "row"])
def test_mixed_arm_takes_unaligned_views(cuda, m, k, n, offset):
    """x a bf16 view one or two elements or one row into its storage: a base
    only 2- or 4-byte aligned takes the synchronous or the 4-byte loads, and
    the result still equals the f32 kernel on x.float() bit for bit."""
    gen = torch.Generator().manual_seed(m + k * n)
    start = k if offset == "row" else offset
    x = _bf16(gen, (m + 1) * k + 2).to(cuda)[start:start + m * k].view(m, k)
    w = torch.randn(k, n, generator=gen).to(cuda)
    for out in OUTS.values():
        assert torch.equal(arype_matmul(x, w, activation="silu", out_dtype=out),
                           arype_matmul(x.float(), w, activation="silu").to(out))


@pytest.mark.parametrize("k,n", LM_KN + [LM_HEAD[1:], (301, 163)])
def test_mixed_arm_rows_do_not_depend_on_m(cuda, k, n):
    """As the f32 arm: a 4-slot decode call's rows equal single-row calls."""
    gen = torch.Generator().manual_seed(k + n)
    x, w = _bf16(gen, 4, k).to(cuda), torch.randn(k, n, generator=gen).to(cuda)
    out = arype_matmul(x, w)
    for s in range(4):
        assert torch.equal(arype_matmul(x[s:s + 1], w), out[s:s + 1]), s


@pytest.mark.parametrize("m,k,n", [(1, 1024, 2048), (1, 1024, 1024), (1, 2048, 1024),
                                   (1, 1152, 256), (7, 16, 8), (1024, 6, 12), (33, 1, 2)])
@pytest.mark.parametrize("act", ["none", "silu"])
@pytest.mark.parametrize("out", list(OUTS))
def test_vpe_mixed_arm_equals_the_f32_kernel_on_upcast_x(cuda, m, k, n, act, out):
    """The VPE's mixed arm, at the one-row projections the router places
    there (batch-1 decode of qwen3-0.6b and gemma3-1b) and the pipeline's
    shapes: bit for bit the f32 kernel on x.float(), one launch."""
    gen = torch.Generator().manual_seed(m + k + n)
    x, w = _bf16(gen, m, k).to(cuda), torch.randn(k, n, generator=gen).to(cuda)
    before = kernels.launches()
    got = vpe_matmul(x, w, activation=act, out_dtype=OUTS[out])
    assert kernels.launches()["vpe_mm"] == before["vpe_mm"] + 1
    assert torch.equal(got, vpe_matmul(x.float(), w, activation=act).to(OUTS[out]))


# (k, n) of the one-row projections a batch-1 decode places on the VPE:
# qwen3-0.6b's wq, wk (= wv), wo; gemma3-1b's wq, wk (= wv), wo
BATCH1_KN = [(1024, 2048), (1024, 1024), (2048, 1024), (1152, 1024), (1152, 256), (1024, 1152)]


@pytest.mark.parametrize("k,n", BATCH1_KN)
@pytest.mark.parametrize("arm", ["f32", "bf16 x -> bf16", "bf16 x -> f32"])
def test_vpe_equals_arype_at_up_to_8_rows(cuda, k, n, arm):
    """At M 1-8 the VPE runs the AryPE's skinny split-K with the same plan:
    one vpe_mm launch, the same bits as arype_matmul, in both arms and under
    every activation, and each row equal to a one-row call on it."""
    gen = torch.Generator().manual_seed(k + n)
    w = torch.randn(k, n, generator=gen).to(cuda)
    x8 = torch.randn(8, k, generator=gen).to(cuda)
    x8 = x8 if arm == "f32" else x8.bfloat16()
    od = torch.float32 if arm.endswith("f32") else torch.bfloat16
    for m in range(1, 9):
        x = x8[:m].contiguous()
        for act in ("none", "relu", "silu", "gelu"):
            before = kernels.launches()
            got = vpe_matmul(x, w, activation=act, out_dtype=od)
            after = kernels.launches()
            assert after["vpe_mm"] == before["vpe_mm"] + 1
            assert sum(after.values()) == sum(before.values()) + 1
            assert torch.equal(got, arype_matmul(x, w, activation=act, out_dtype=od)), (m, act)
        full = vpe_matmul(x, w, out_dtype=od)
        for r in range(m):
            assert torch.equal(vpe_matmul(x[r:r + 1].contiguous(), w, out_dtype=od),
                               full[r:r + 1]), (m, r)


def test_engines_refuse_bf16_weights_on_the_card(cuda):
    """bf16 weights run on the card now, in every (x, w, out) pair of types,
    one launch each; what is still refused is refused before any launch: a
    float16 operand by the wrappers, an unknown dtype code (2) by each
    engine launcher itself, and bf16 by the unfused ablation."""
    x, w = torch.randn(4, 8, device=cuda), torch.randn(8, 3, device=cuda)
    for engine in (arype_matmul, vpe_matmul):
        before = kernels.launches()
        assert engine(x.bfloat16(), w.bfloat16()).dtype == torch.bfloat16
        assert engine(x, w.bfloat16(), out_dtype=torch.bfloat16).dtype == torch.bfloat16
        assert sum(kernels.launches().values()) == sum(before.values()) + 2
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            engine(x.half(), w)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            engine(x, w.half())
    out = torch.empty(4, 3, dtype=torch.bfloat16, device=cuda)
    plan = operand_plan(x, w)
    vplan = vpe_plan(4, 8, 3)
    f32, unknown = DTYPES[torch.float32], 2
    before = kernels.launches()
    for kernel, args in ((MM_FUSED, (0, plan.tile, plan.split)),
                         (VPE_MM, (0, vplan.bn, vplan.split))):
        for codes in ((unknown, f32, f32), (f32, unknown, f32), (f32, f32, unknown)):
            with pytest.raises(RuntimeError, match="CUDA error"):
                kernel(x.device, x.data_ptr(), w.data_ptr(), out.data_ptr(), 4, 8, 3, *args,
                       *codes, stream_of(x))
    sw = scale_row(0.1, 3, cuda)
    qplan = vpe_q_plan(4, 8, 3)
    for kernel, args in ((MM_FUSED_Q, (0, mm_fused_q_plan(4, 8, 3).tile)),
                         (VPE_MM_Q, (0, *qplan))):
        with pytest.raises(RuntimeError, match="CUDA error"):
            kernel(x.device, x.data_ptr(), w.data_ptr(), 0.1, sw.data_ptr(), out.data_ptr(),
                   4, 8, 3, *args, f32, unknown, f32, stream_of(x))
    assert kernels.launches() == before
    with pytest.raises(ValueError, match="ROADMAP Queue 2 item 1"):
        arype_matmul_unfused(x.bfloat16(), w)


# the bf16-weight arms: every (x, w, out) pair of types at the LM's shapes on
# both variants (the skinny one at M <= 8, tf32x3 past it), starcoder2-15b's
# K 6144 into N 512 (k, v) and a 49152-wide head slice, ragged N and odd K
# (w's synchronous copies at N 7, 65, 163, 258 and 130; x's at K 5, 301,
# 1027), and K 6 (x's 4-byte copies)
BF16W_SHAPES = [(1, 1024, 1024), (4, 1024, 3072), (8, 257, 130), (3, 301, 163), (9, 301, 163),
                (77, 1027, 258), (33, 301, 65), (40, 6, 128), (129, 5, 7), (1032, 1024, 1024),
                (4, 6144, 512), (300, 6144, 512), (4, 512, 49152)]
DTYPE_TRIPLES = list(itertools.product((torch.float32, torch.bfloat16), repeat=3))
TRIPLE_IDS = ["-".join(str(t)[6:] for t in triple) for triple in DTYPE_TRIPLES]


def _step(ref: torch.Tensor) -> torch.Tensor:
    """One bf16 step (ulp) at each |ref|."""
    return torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0**-126))) - 7)


def _holds_wgmma_bounds(got, x, w, act, ot):
    """mm_fused's wgmma variant (bf16 x, bf16 w) against the f64 product of
    the same operands, the activation in f64: it sums K in another order
    than the f32 arm, so bounds, not bits.  f32 out at most twice the
    largest error of the f32 arm on x.float(), w.float() (the tf32x3
    variant); bf16 out its own f32 output rounded once, bit for bit, and
    within one bf16 step of the f64 product (plus 1e-5 of its max: near 0 a
    difference of f32 sums cancels below any relative step)."""
    from repro_torch.common.util import apply_activation

    exact = apply_activation(x.double() @ w.double(), act)
    err = (got.double() - exact).abs()
    if ot == torch.float32:
        upcast = arype_matmul(x.float(), w.float(), activation=act)
        return err.max() <= 2 * (upcast.double() - exact).abs().max()
    f32 = arype_matmul(x, w, activation=act, out_dtype=torch.float32)
    return bool(torch.equal(got, f32.to(ot))
                and (err <= _step(exact) + 1e-5 * exact.abs().max()).all())


@pytest.mark.parametrize("m,k,n", BF16W_SHAPES)
@pytest.mark.parametrize("xt,wt,ot", DTYPE_TRIPLES, ids=TRIPLE_IDS)
def test_every_dtype_pair_equals_the_f32_kernel_on_upcast_operands(cuda, m, k, n, xt, wt, ot):
    """mm_fused on x of xt, w of wt into ot: one launch, bit for bit the f32
    kernel on x.float(), w.float() rounded once to ot (a bf16 value is a tf32
    value with lo = 0, and the skinny variant widens it exactly), under every
    activation, and within one bf16 step (f32 out: rtol 1e-5) of the plain
    twin.  bf16 x on bf16 w at M > 8 with operands TMA can load runs the
    wgmma variant, which sums K in another order: there the equality is
    :func:`_holds_wgmma_bounds` against an f64 product instead."""
    gen = torch.Generator().manual_seed(m * 3 + k + n)
    x = torch.randn(m, k, generator=gen).to(cuda, xt)
    w = torch.randn(k, n, generator=gen).to(cuda, wt)
    wgmma = operand_plan(x, w).variant == "wgmma"
    assert wgmma == (xt == wt == torch.bfloat16 and m > 8 and k % 8 == 0 and n % 8 == 0)
    for act in ("none", "relu", "silu", "gelu"):
        before = kernels.launches()
        got = arype_matmul(x, w, activation=act, out_dtype=ot)
        after = kernels.launches()
        assert after["mm_fused"] == before["mm_fused"] + 1
        assert sum(after.values()) == sum(before.values()) + 1
        assert got.dtype == ot
        if wgmma:
            assert _holds_wgmma_bounds(got, x, w, act, ot), act
        else:
            assert torch.equal(got, arype_matmul(x.float(), w.float(), activation=act).to(ot)), act
        ref = mm_fused(x, w, activation=act, out_dtype=ot).float()
        top = ref.abs().max()
        tol = _step(ref) if ot == torch.bfloat16 else 1e-5 * ref.abs()
        assert ((got.float() - ref).abs() <= tol + 1e-5 * top).all(), act


# the wgmma variant (bf16 x, bf16 w, M > 8, TMA-loadable): ragged M (9, 65,
# 129, 1200 against the 64- and 128-row tiles), K off the 64-deep tile (72,
# 6144 + 8), N off the 64- and 128-column tiles (264) and on them (1024), a
# 49152-wide head slice
WGMMA_SHAPES = [(9, 72, 264), (65, 6152, 1024), (129, 72, 1024), (1200, 6152, 264),
                (1200, 72, 1024), (9, 6144, 49152), (129, 6144, 264)]


@pytest.mark.parametrize("m,k,n", WGMMA_SHAPES)
def test_wgmma_variant_holds_its_bounds_at_ragged_edges(cuda, m, k, n):
    """One launch of the wgmma variant under every activation into bf16 and
    f32, within its bounds of the f64 product and one bf16 step (f32 out:
    rtol 1e-5) of the plain twin, and the same bits when called again."""
    gen = torch.Generator().manual_seed(m + k + n)
    x = torch.randn(m, k, generator=gen).to(cuda, torch.bfloat16)
    w = torch.randn(k, n, generator=gen).to(cuda, torch.bfloat16)
    assert operand_plan(x, w).variant == "wgmma"
    for ot in OUTS.values():
        for act in ("none", "relu", "silu", "gelu"):
            kernels.reset_launches()
            got = arype_matmul(x, w, activation=act, out_dtype=ot)
            assert kernels.launches()["mm_fused"] == 1
            assert kernels.mm_fused_variants()["wgmma"] == 1
            assert torch.equal(got, arype_matmul(x, w, activation=act, out_dtype=ot)), act
            assert _holds_wgmma_bounds(got, x, w, act, ot), (act, ot)
            ref = mm_fused(x, w, activation=act, out_dtype=ot).float()
            tol = _step(ref) if ot == torch.bfloat16 else 1e-5 * ref.abs()
            assert ((got.float() - ref).abs() <= tol + 1e-5 * ref.abs().max()).all(), act


@pytest.mark.parametrize("k,n", [(6144, 512), (1024, 1024), (72, 264)])
def test_wgmma_rows_do_not_depend_on_m_or_the_tile(cuda, k, n):
    """Rows of a 1032-row call equal those of 33-, 65- and 200-row calls on
    them, across the 64- and 128-row tiles and the column tiles the plan
    picks for each M: the K order is the kernel's constant."""
    gen = torch.Generator().manual_seed(k + n)
    w = torch.randn(k, n, generator=gen).to(cuda, torch.bfloat16)
    x = torch.randn(1032, k, generator=gen).to(cuda, torch.bfloat16)
    out = arype_matmul(x, w)
    assert {operand_plan(x[:rows], w).bm for rows in (33, 65, 200, 1032)} == {64, 128}
    for rows in (33, 65, 200):
        assert torch.equal(arype_matmul(x[:rows], w), out[:rows]), rows


def test_wgmma_tiles_refuse_what_tma_cannot_load(cuda):
    """The entry point refuses a wgmma tile, launching nothing, for f32 or
    mixed operands, M <= 8, K or N off a multiple of 8, an unaligned base."""
    x = torch.randn(64, 80, device=cuda).bfloat16()
    w = torch.randn(80, 64, device=cuda).bfloat16()
    out = torch.empty(64, 64, device=cuda)
    tile = operand_plan(x, w).tile
    bf16, f32 = DTYPES[torch.bfloat16], DTYPES[torch.float32]
    cases = [(x, w, 64, 80, 64, f32, bf16), (x, w, 64, 80, 64, bf16, f32),
             (x, w, 8, 80, 64, bf16, bf16), (x, w, 64, 76, 64, bf16, bf16),
             (x, w, 64, 80, 60, bf16, bf16), (x.view(-1)[1:], w, 64, 80, 64, bf16, bf16),
             (x, w.view(-1)[4:], 64, 80, 64, bf16, bf16)]
    before = kernels.launches()
    for a, b, m, k, n, xd, wd in cases:
        with pytest.raises(RuntimeError, match="CUDA error"):
            MM_FUSED(x.device, a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n, 0, tile, 1,
                     xd, wd, f32, stream_of(x))
    assert kernels.launches() == before
    MM_FUSED(x.device, x.data_ptr(), w.data_ptr(), out.data_ptr(), 64, 80, 64, 0, tile, 1, bf16,
             bf16, f32, stream_of(x))
    assert torch.equal(out, arype_matmul(x, w, out_dtype=torch.float32))


@pytest.mark.parametrize("m,k,n", [(1, 1024, 2048), (1, 6144, 512), (7, 16, 8), (1024, 6, 12),
                                   (33, 1, 2), (5120, 3, 32), (20, 96, 32)])
@pytest.mark.parametrize("xt,wt,ot", DTYPE_TRIPLES, ids=TRIPLE_IDS)
def test_vpe_every_dtype_pair_equals_the_f32_kernel_on_upcast_operands(cuda, m, k, n, xt, wt,
                                                                        ot):
    """vpe_mm on every pair of types, on both of its kernels (the skinny
    split-K at M <= 8, one thread an output past it, w staged or not): one
    launch, bit for bit the f32 kernel on x.float(), w.float()."""
    gen = torch.Generator().manual_seed(m + k + n)
    x = torch.randn(m, k, generator=gen).to(cuda, xt)
    w = torch.randn(k, n, generator=gen).to(cuda, wt)
    for act in ("none", "silu"):
        before = kernels.launches()
        got = vpe_matmul(x, w, activation=act, out_dtype=ot)
        assert kernels.launches()["vpe_mm"] == before["vpe_mm"] + 1
        assert got.dtype == ot
        assert torch.equal(got, vpe_matmul(x.float(), w.float(), activation=act).to(ot)), act


@pytest.mark.parametrize("k,n", [(1024, 2048), (6144, 512), (6144, 6144), (301, 163), (257, 130)])
@pytest.mark.parametrize("xt,wt,ot", DTYPE_TRIPLES, ids=TRIPLE_IDS)
def test_vpe_equals_arype_at_up_to_8_rows_in_every_dtype_pair(cuda, k, n, xt, wt, ot):
    """At M 1-8 both engines launch the skinny split-K with one plan, in
    every pair of types: the same bits, and each row equal to a one-row
    call on it."""
    gen = torch.Generator().manual_seed(k + n)
    w = torch.randn(k, n, generator=gen).to(cuda, wt)
    x8 = torch.randn(8, k, generator=gen).to(cuda, xt)
    for m in range(1, 9):
        x = x8[:m].contiguous()
        for act in ("none", "gelu"):
            got = vpe_matmul(x, w, activation=act, out_dtype=ot)
            assert torch.equal(got, arype_matmul(x, w, activation=act, out_dtype=ot)), (m, act)
        full = arype_matmul(x, w, out_dtype=ot)
        for r in range(m):
            assert torch.equal(arype_matmul(x[r:r + 1].contiguous(), w, out_dtype=ot),
                               full[r:r + 1]), (m, r)


@pytest.mark.parametrize("k,n", [(1024, 1024), (6144, 512), (301, 163)])
@pytest.mark.parametrize("xt", [torch.float32, torch.bfloat16], ids=["f32x", "bf16x"])
def test_bf16_weight_rows_do_not_depend_on_m(cuda, k, n, xt):
    """bf16 w: rows of a 4-row decode call equal one-row calls (the skinny
    variant), and rows of a 40-row call equal those of 9- and 33-row calls
    on them (the tf32x3 variant: K's order never depends on M)."""
    gen = torch.Generator().manual_seed(k * n)
    w = torch.randn(k, n, generator=gen).to(cuda, torch.bfloat16)
    x = torch.randn(40, k, generator=gen).to(cuda, xt)
    out4 = arype_matmul(x[:4], w)
    for s in range(4):
        assert torch.equal(arype_matmul(x[s:s + 1], w), out4[s:s + 1]), s
    out = arype_matmul(x, w)
    for rows in (9, 33):
        assert torch.equal(arype_matmul(x[:rows], w), out[:rows]), rows


@pytest.mark.parametrize("m,k,n", [(4, 1024, 1024), (37, 96, 64), (129, 300, 163), (9, 301, 8),
                                   (1032, 1024, 1024)])
@pytest.mark.parametrize("offset", [1, 2, 8, "row"])
def test_bf16_weights_take_unaligned_views(cuda, m, k, n, offset):
    """w a bf16 view 1, 2 or 8 elements or one row into its storage: a base
    not 16-byte aligned takes the synchronous loads (tf32x3) or the scalar
    ones (skinny), and the result still equals the f32 kernel on w.float()
    bit for bit.  A view whose base is 16-byte aligned under a bf16 x of
    K and N multiples of 8 at M > 8 runs the wgmma variant, held to
    :func:`_holds_wgmma_bounds` instead."""
    gen = torch.Generator().manual_seed(m + k * n)
    start = n if offset == "row" else offset
    w = torch.randn((k + 1) * n + 8, generator=gen).to(cuda, torch.bfloat16)
    w = w[start:start + k * n].view(k, n)
    for xt in (torch.float32, torch.bfloat16):
        x = torch.randn(m, k, generator=gen).to(cuda, xt)
        wgmma = operand_plan(x, w).variant == "wgmma"
        assert not wgmma or (offset in (8, "row") and xt == torch.bfloat16)
        for out in OUTS.values():
            got = arype_matmul(x, w, activation="silu", out_dtype=out)
            if wgmma:
                assert _holds_wgmma_bounds(got, x, w, "silu", out)
            else:
                assert torch.equal(got, arype_matmul(x.float(), w.float(),
                                                     activation="silu").to(out))


@pytest.mark.parametrize("engine,plain", [(vpe_matmul_q, vpe_mm_q), (arype_matmul_q, mm_fused_q)])
@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (37, 5, 7), (1024, 6, 12), (5120, 3, 32),
                                   (2560, 96, 32), (256, 128, 162), (3840, 16, 64),
                                   (33, 300, 163), (4, 1024, 1024)])
@pytest.mark.parametrize("xt,wt,ot", DTYPE_TRIPLES, ids=TRIPLE_IDS)
def test_int8_kernels_take_every_dtype_pair(cuda, engine, plain, m, k, n, xt, wt, ot):
    """The int8 pair on x of xt and w of wt into ot (the reference's
    ``out_dtype or x.dtype``): each element quantized as its exact f32, the
    int32 sums exact, so bit for bit with the plain twin under none/relu,
    per tensor and per channel; one launch."""
    gen = torch.Generator().manual_seed(m + k + n)
    x = (torch.randn(m, k, generator=gen) * 3).to(cuda, xt)
    w = torch.randn(k, n, generator=gen).to(cuda, wt)
    sx = pick_scale(x.float().abs().max().item())
    for sw in (pick_scale(w.float().abs().max().item()),
               tuple(pick_scale(v) for v in w.float().abs().amax(0).tolist())):
        for act in ("none", "relu"):
            before = kernels.launches()
            out = engine(x, w, scale_x=sx, scale_w=sw, activation=act, out_dtype=ot)
            assert sum(kernels.launches().values()) == sum(before.values()) + 1
            assert out.dtype == ot
            assert torch.equal(out, plain(x, w, scale_x=sx, scale_w=sw, activation=act,
                                          out_dtype=ot))
            assert torch.equal(out, engine(x.float(), w.float(), scale_x=sx, scale_w=sw,
                                           activation=act).to(ot))


# the int8 kernels' shapes: the pipelines', and ragged ones across the 32-row
# tiles' edges (M 8/9/33, N 162/163) at K 5 and 300, which take 4-byte copies
INT8_SHAPES = ([(1, 1, 1), (37, 5, 7), (1024, 6, 12), (1024, 12, 6), (1024, 6, 3), (1024, 3, 2),
                (5120, 3, 32), (2560, 96, 32), (1280, 96, 32), (256, 96, 128), (256, 128, 162)]
               + TF_SHAPES + [(8, 300, 162), (9, 5, 163), (33, 300, 163), (33, 5, 162)])


@pytest.mark.parametrize("engine,plain", [(vpe_matmul_q, vpe_mm_q), (arype_matmul_q, mm_fused_q)])
@pytest.mark.parametrize("m,k,n", INT8_SHAPES)
@pytest.mark.parametrize("per_channel", [False, True], ids=["tensor", "channel"])
@pytest.mark.parametrize("act", ["none", "relu", "silu", "gelu"])
def test_int8_kernels_match_plain(cuda, engine, plain, m, k, n, per_channel, act):
    gen = torch.Generator().manual_seed(m + k + n)
    x = (torch.randn(m, k, generator=gen) * 3).to(cuda)
    w = torch.randn(k, n, generator=gen).to(cuda)
    sx = pick_scale(x.abs().max().item())
    sw = (tuple(pick_scale(v) for v in w.abs().amax(0).tolist()) if per_channel
          else pick_scale(w.abs().max().item()))
    before = kernels.launches()
    out = engine(x, w, scale_x=sx, scale_w=sw, activation=act)
    ref = plain(x, w, scale_x=sx, scale_w=sw, activation=act)
    assert sum(kernels.launches().values()) == sum(before.values()) + 1
    if act in ("none", "relu"):  # integer sums and one f32 product: bit for bit
        assert torch.equal(out, ref)
    else:  # the activation's exp/tanh differ between the kernel and torch
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5 * ref.abs().max().item())


# the unfused matmul's shapes: the loop's convs, Table 6's, and ragged ones
# across the 32-row tiles' and the K blocks' edges (4-byte copies at K 5, N
# 162/163 and bk 20)
UNFUSED_SHAPES = [(1, 1, 1), (37, 5, 7), (2560, 96, 32), (1280, 96, 32), (1000, 128, 162),
                  (33, 200, 17), (20000, 3, 32), (8, 300, 162), (9, 5, 163), (33, 300, 163)]


@pytest.mark.parametrize("m,k,n", UNFUSED_SHAPES)
@pytest.mark.parametrize("bk", [32, None, 20, 48])
@pytest.mark.parametrize("act", ["none", "relu", "silu", "gelu"])
def test_unfused_kernels_match_plain(cuda, m, k, n, bk, act):
    gen = torch.Generator().manual_seed(m + k + n)
    x = torch.randn(m, k, generator=gen).to(cuda)
    w = torch.randn(k, n, generator=gen).to(cuda)
    depth = bk or 128
    before = kernels.launches()
    partials = mm_unfused_partials(x, w, bk=depth)
    out = arype_matmul_unfused(x, w, activation=act, bk=bk)
    after = kernels.launches()
    # one partials launch each, one sum launch for the whole matmul, nothing else
    assert after["mm_unfused_partials"] == before["mm_unfused_partials"] + 2
    assert after["mm_partials_sum"] == before["mm_partials_sum"] + 1
    assert sum(after.values()) == sum(before.values()) + 3
    ref = mm_unfused_partials_plain(x, w, bk=depth)
    assert partials.shape == (-(-k // depth), m, n)
    torch.testing.assert_close(partials, ref, rtol=1e-5, atol=1e-5 * ref.abs().max().item())
    ref = mm_unfused(x, w, activation=act, bk=depth)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5 * ref.abs().max().item())


def _view_at(flat: torch.Tensor, start: int, rows: int, cols: int) -> torch.Tensor:
    """(rows, cols) view of ``flat`` from element ``start``: one row in
    (``start`` = cols) keeps the base 16-byte aligned only where cols is a
    multiple of 4; one float in (``start`` = 1) leaves it 4-byte aligned at
    any cols, so the launchers take 4-byte copies of x for the base alone."""
    return flat[start:start + rows * cols].view(rows, cols)


OFFSETS = {"row": lambda k: k, "float": lambda k: 1}


@pytest.mark.parametrize("m,k,n", [(37, 5, 7), (33, 300, 163), (2560, 96, 32), (257, 6, 12)])
@pytest.mark.parametrize("per_channel", [False, True], ids=["tensor", "channel"])
@pytest.mark.parametrize("offset", list(OFFSETS))
def test_int8_kernel_takes_row_offset_views(cuda, m, k, n, per_channel, offset):
    """x a view into a larger tensor, one row or one float in (its base only
    4-byte aligned at K 96 and 300 too): bit for bit with the twin."""
    gen = torch.Generator().manual_seed(m * k + n)
    x = _view_at((torch.randn((m + 1) * k, generator=gen) * 3).to(cuda), OFFSETS[offset](k), m, k)
    w = torch.randn(k, n, generator=gen).to(cuda)
    sx = pick_scale(x.abs().max().item())
    sw = (tuple(pick_scale(v) for v in w.abs().amax(0).tolist()) if per_channel
          else pick_scale(w.abs().max().item()))
    for act in ("none", "relu"):
        assert torch.equal(arype_matmul_q(x, w, scale_x=sx, scale_w=sw, activation=act),
                           mm_fused_q(x, w, scale_x=sx, scale_w=sw, activation=act))


@pytest.mark.parametrize("m,k,n,bk", [(37, 5, 7, 20), (33, 300, 163, 48), (2560, 96, 32, 32),
                                      (129, 6, 65, 20)])
@pytest.mark.parametrize("offset", list(OFFSETS))
def test_unfused_kernels_take_row_offset_views(cuda, m, k, n, bk, offset):
    gen = torch.Generator().manual_seed(m * k + n)
    x = _view_at(torch.randn((m + 1) * k, generator=gen).to(cuda), OFFSETS[offset](k), m, k)
    w = torch.randn(k, n, generator=gen).to(cuda)
    ref = mm_unfused_partials_plain(x, w, bk=bk)
    torch.testing.assert_close(mm_unfused_partials(x, w, bk=bk), ref, rtol=1e-5,
                               atol=1e-5 * ref.abs().max().item())


@pytest.mark.parametrize("m,k,n", [(2560, 96, 32), (1280, 96, 32), (9, 5, 163), (33, 300, 163)]
                         + [s[1:] for s in usecase2_layers(1000)])
@pytest.mark.parametrize("act", ["none", "relu", "silu", "gelu"])
def test_unfused_at_bk_32_equals_fused(cuda, m, k, n, act):
    """For M > 8 both run the same 3xTF32 32-deep K tiles: each partial is a
    promoted tile sum of the fused kernel, and the sum pass adds them in the
    fused kernel's order, so the unfused product equals it bit for bit (the
    unfused CNN loop and Table 6 run bk = 32)."""
    gen = torch.Generator().manual_seed(m + k * n)
    x = torch.randn(m, k, generator=gen).to(cuda)
    w = torch.randn(k, n, generator=gen).to(cuda)
    assert m > 8
    assert torch.equal(arype_matmul_unfused(x, w, activation=act, bk=32),
                       arype_matmul(x, w, activation=act))


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,mask,window,kv_len", [
    (2, 4, 2, 256, 256, 32, "causal", 0, None), (1, 4, 1, 128, 384, 16, "full", 0, None),
    (2, 2, 2, 300, 300, 32, "local", 64, None), (1, 8, 4, 256, 512, 64, "causal", 0, None),
    (1, 2, 2, 64, 64, 128, "local", 16, None), (1, 4, 1, 128, 384, 16, "full", 0, 200),
    (1, 4, 1, 77, 190, 256, "local", 20, 5), (1, 2, 2, 50, 70, 8, "full", 0, 33),
    (4, 16, 8, 161, 161, 128, "causal", 0, None), (1, 1, 1, 1, 1, 16, "causal", 0, None),
    # the bf16 kernel's widths (D zero-filled to 16, 32, 64, 128 or 256) and
    # ragged edges of its 64-row and 64- or 32-key tiles: D 24 to 200 between
    # them, kv_len inside a tile, Sq past Sk, and a local window with kv_len 20
    # that leaves rows 27.. of D 48 fully masked
    (1, 2, 1, 33, 97, 24, "causal", 0, None), (2, 4, 2, 129, 70, 40, "full", 0, 50),
    (1, 4, 4, 100, 100, 72, "local", 30, None), (1, 2, 1, 65, 131, 136, "causal", 0, 100),
    (1, 2, 2, 70, 257, 200, "local", 64, 190), (1, 2, 1, 90, 90, 48, "local", 8, 20),
    (4, 16, 8, 258, 258, 128, "causal", 0, None), (1, 4, 1, 300, 300, 256, "local", 64, None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_flash_kernel_matches_plain(cuda, b, hq, hkv, sq, sk, d, mask, window, kv_len, dtype,
                                    layout):
    """One launch, within f32 rtol = atol 2e-5 (the reference test's) and
    bf16 rtol 2^-7, atol 1e-5 (both sides compute in f32 and round the output
    once: one bf16 step of the value at most); fully masked rows exactly 0;
    "bshd" hands the kernel transposed views, as the LM does."""
    gen = torch.Generator().manual_seed(sq + sk + d)

    def rand(h, s):
        if layout == "bshd":
            return torch.randn(b, s, h, d, generator=gen).to(cuda, dtype).transpose(1, 2)
        return torch.randn(b, h, s, d, generator=gen).to(cuda, dtype)

    q, k, v = rand(hq, sq), rand(hkv, sk), rand(hkv, sk)
    kw = dict(mask=mask, window=window, kv_len=kv_len)
    before = kernels.launches()
    out = flash_attention(q, k, v, **kw)
    after = kernels.launches()
    assert after["flash_fwd"] == before["flash_fwd"] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    ref = flash_attention_plain(q, k, v, **kw)
    assert out.dtype == dtype and out.shape == ref.shape
    rtol, atol = (2.0**-7, 1e-5) if dtype == torch.bfloat16 else (2e-5, 2e-5)
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=atol)
    dead = ~valid_pairs(mask, window, sk if kv_len is None else kv_len,
                        torch.arange(sq, device=cuda)[:, None],
                        torch.arange(sk, device=cuda)[None]).any(dim=1)
    assert (out[:, :, dead] == 0).all()


@pytest.mark.parametrize("offset", [4, 8, 1024])
@pytest.mark.parametrize("d", [8, 128])
def test_flash_bf16_takes_unaligned_views(cuda, offset, d):
    """bf16 q, k, v as views ``offset`` elements into their storage: 8 and
    1024 keep every row 16-byte aligned (cp.async copies), 4 leaves them 8-byte
    aligned (element loads); the same values either way."""
    gen = torch.Generator().manual_seed(offset + d)
    shape = (2, 4, 75, d)
    n = 2 * 4 * 75 * d
    views = [torch.randn(n + offset, generator=gen).to(cuda, torch.bfloat16)[offset:].view(shape)
             for _ in range(3)]
    dense = [t.clone() for t in views]
    for mask, kv_len in (("causal", None), ("full", 40)):
        out = flash_attention(*views, mask=mask, kv_len=kv_len)
        assert torch.equal(out, flash_attention(*dense, mask=mask, kv_len=kv_len))
        ref = flash_attention_plain(*dense, mask=mask, kv_len=kv_len)
        torch.testing.assert_close(out.float(), ref.float(), rtol=2.0**-7, atol=1e-5)


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.randn(1, 2, 8, 12, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_attention(q, q, q)
    q = torch.randn(1, 2, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="D contiguous"):
        flash_attention(q.transpose(2, 3), q.transpose(2, 3), q.transpose(2, 3))


@pytest.mark.parametrize("arch,slots", [("qwen3-0.6b", 2), ("gemma3-1b", 2), ("gemma3-1b", 3)])
def test_lm_serve_on_card_matches_cpu(cuda, arch, slots):
    """A short serve of a reduced LM on the card and on the CPU: the same
    tokens, and on the card one flash_fwd a layer a prefill."""
    cfg = reduced_config(get_config(arch))
    params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, 20 + 3 * i) for i in range(3)]
    tokens = []
    for device, p in (("cpu", params), (cuda, _to(params, cuda))):
        eng = ServeEngine(cfg, p, ServeConfig(batch_slots=slots, cache_len=64), device=device)
        reqs = [Request(rid=i, prompt=pr, max_new=6) for i, pr in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        kernels.reset_launches()
        assert len(eng.run_until_drained()) == 3
        tokens.append([r.out_tokens for r in reqs])
        counts = kernels.launches()
    assert tokens[0] == tokens[1]
    assert counts["flash_fwd"] == cfg.num_layers * eng.stats.prefills == cfg.num_layers * 3


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma3-1b"])
@pytest.mark.parametrize("policy", ["collaborative", "arype_only"])
def test_lm_bf16_serve_on_card_matches_single_requests(cuda, arch, policy):
    """A reduced LM in bf16 compute served on the card: every request's
    tokens equal its single-request run on the card, since each matmul is
    placed alike at 1 and 2 slots here (arype_only: all on mm_fused; the
    collaborative reduced shapes: decode and the head on the VPE, prefill's
    wider ones on the tf32x3 variant) and no kernel's rows depend on M;
    launches are one engine matmul a routed layer and one flash_fwd a layer a
    prefill."""
    cfg = reduced_config(get_config(arch)).replace(compute_dtype="bfloat16",
                                                   router_policy=policy)
    params = _to(LM(cfg, device="cpu").init(torch.Generator().manual_seed(0)), cuda)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, 20 + 3 * i) for i in range(3)]
    model = LM(cfg, device=cuda)
    singles = []
    for pr in prompts:
        eng = ServeEngine(cfg, params, ServeConfig(batch_slots=1, cache_len=64), device=cuda)
        eng.submit(Request(rid=0, prompt=pr, max_new=6))
        singles.append(eng.run_until_drained()[0].out_tokens)
    eng = ServeEngine(cfg, params, ServeConfig(batch_slots=2, cache_len=64), device=cuda)
    reqs = [Request(rid=i, prompt=pr, max_new=6) for i, pr in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    kernels.reset_launches()
    eng.run_until_drained()
    counts = kernels.launches()
    assert [r.out_tokens for r in reqs] == singles
    assert counts["flash_fwd"] == cfg.num_layers * 3
    assert counts["mm_fused"] + counts["vpe_mm"] == (7 * cfg.num_layers + 1) * (
        3 + eng.stats.decode_steps)
    if policy == "arype_only":
        assert counts["vpe_mm"] == 0
    logits, _ = model.forward(params, {"tokens": torch.as_tensor(prompts[0][None]).to(cuda)})
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


@pytest.mark.parametrize("policy", ["arype_only", "collaborative"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_collaborative_forward_on_card_matches_cpu(cuda, policy, fused):
    rng = np.random.default_rng(5)
    x, *ws = (torch.as_tensor(rng.normal(size=s).astype(np.float32))
              for s in ((1000, 300), (300, 64), (64, 96), (96, 8)))
    acts = ["relu", "gelu", None]
    cfg = RuntimeConfig(policy=policy, fused_aggregation=fused)
    plan = plan_stack(x, ws, config=cfg)
    engines = [s.engine for s in plan.steps]
    assert engines == (["arype"] * 3 if policy == "arype_only" else ["arype", "arype", "vpe"])
    want = collaborative_forward(x, ws, acts, plan=plan)
    kernels.reset_launches()
    got = collaborative_forward(x.to(cuda), [w.to(cuda) for w in ws], acts, plan=plan)
    counts = kernels.launches()
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5 * want.abs().max().item())
    # an AryPE step: mm_fused, or unfused one partials and one sum launch;
    # a VPE step (the plan's route through router.matmul): vpe_mm
    n_arype = engines.count("arype")
    expect = dict.fromkeys(counts, 0)
    expect.update(vpe_mm=engines.count("vpe"))
    if fused:
        expect["mm_fused"] = n_arype
    else:
        expect.update(mm_unfused_partials=n_arype, mm_partials_sum=n_arype)
    assert counts == expect


@pytest.mark.parametrize("flow_model,runtime_kw", [
    ("transformer", {}), ("transformer", dict(quantize=True)),
    ("cnn", dict(fused_aggregation=False, vpe_max_elems=1 << 16))],
    ids=["transformer_f32", "transformer_int8", "cnn_unfused"])
def test_slice3_pipelines_on_card_match_cpu(cuda, flow_model, runtime_kw):
    mlp = init_paper_model("mlp", torch.Generator().manual_seed(1), device="cpu")
    flow = init_paper_model(flow_model, torch.Generator().manual_seed(3), device="cpu")
    cfg = PipelineConfig(batch_size=256, max_ready=64, table_size=1024, flow_model=flow_model)
    if runtime_kw.get("quantize"):
        runtime_kw = dict(runtime_kw, quant_scales=calibrate_quant_scales(
            mlp, flow, flow_model=flow_model, max_flip_rate=None, device="cpu"))
    runtime = RuntimeConfig(**runtime_kw)
    gpu = OctopusPipeline(mlp, flow, cfg, config=runtime)
    cpu = OctopusPipeline(mlp, flow, cfg, config=runtime, device="cpu")
    gen = TrafficGenerator(TrafficConfig(batch_size=256, active_flows=64, table_size=1024,
                                         elephant_fraction=0.5), device="cpu")
    steps, counts, drained = 12, dict.fromkeys(kernels.launches(), 0), 0
    for step in range(steps):
        batch = gen.next_batch()
        kernels.reset_launches()
        out_g = gpu.step(ft.PacketBatch(*(a.to(cuda) for a in batch)))
        counts = {name: counts[name] + n for name, n in kernels.launches().items()}
        with record_routes() as routes:
            out_c = cpu.step(batch)
        for a, b in zip(gpu.state, cpu.state):
            assert torch.equal(a.cpu(), b)
        for a, b in zip(out_g.drained, out_c.drained):
            assert torch.equal(a.cpu(), b)
        mask = out_c.drained.mask
        drained += int(mask.sum())
        x_c = cpu.flow_engine.prep(out_c.drained.series, out_c.drained.payload)
        if flow_model == "cnn" and mask.any():
            # torch's log1p differs between the devices: both get the CPU's input
            want = cpu.flow_engine.fn(cpu.flow_engine.params, x_c)[mask]
            got = gpu.flow_engine.fn(gpu.flow_engine.params, x_c.to(cuda)).cpu()[mask]
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())
        if flow_model == "transformer" and mask.any():
            x_g = gpu.flow_engine.prep(out_g.drained.series, out_g.drained.payload)
            assert torch.equal(x_g.cpu(), x_c)  # a multiply by an f32 constant: exact
            # the devices' exp (softmax) and attention sums differ in the last
            # bits; int8 re-quantizes the attention output, where such a bit
            # can move a code by one (see chip_smoke.TF_LOGIT_TOL)
            tol = 2e-2 if runtime.quantize else 1e-4
            want = cpu.flow_engine.fn(cpu.flow_engine.params, x_c)[mask]
            got = gpu.flow_engine.fn(gpu.flow_engine.params, x_g).cpu()[mask]
            torch.testing.assert_close(got, want, rtol=0, atol=tol * want.abs().max().item())
    assert drained > 0
    want = kernels.matmul_launches(routes, steps)
    want["flow_update"] += steps
    assert counts == want
    if not runtime.fused_aggregation:
        assert counts["mm_unfused_partials"] > 0


# (P, F) of the fold's card checks: the plan's boundaries (cap - 1, cap, cap +
# 1: the chunked variant, and 3 x cap), P 0 (the copy alone), 1 and 31, F 1,
# 1000 and 65536, and the pipeline's (1024, 8192)
FLOW_CAP = ff.FLOW_CAP
FLOW_SHAPES = [(1024, 8192), (0, 1000), (1, 1000), (31, 1000), (FLOW_CAP - 1, 8192),
               (FLOW_CAP, 8192), (FLOW_CAP + 1, 8192), (3 * FLOW_CAP, 65536), (300, 1),
               (1024, 1000), (1024, 65536)]


def _flow_args(gen, p, f, segments, cross_lane):
    program = ff.default_program("cpu")
    if cross_lane:
        program = torch.stack([torch.arange(16) % 7, torch.randint(0, 13, (16,), generator=gen),
                               torch.randint(0, 16, (16,), generator=gen)], 1).to(torch.int32)
    slots = {"spread": lambda: torch.randint(0, f + 1, (p,), generator=gen),
             "colliding": lambda: torch.randint(0, min(3, f + 1), (p,), generator=gen),
             "one": lambda: torch.full((p,), f // 2),
             "dropped": lambda: torch.full((p,), f)}[segments]().to(torch.int32)
    rand32 = lambda *s: torch.randint(-2**31, 2**31, s, generator=gen,
                                      dtype=torch.int64).to(torch.int32)
    return [program, slots, rand32(p, 13), rand32(f, 16)]


@pytest.mark.parametrize("p,f", FLOW_SHAPES)
@pytest.mark.parametrize("segments", ["spread", "colliding", "one", "dropped"])
@pytest.mark.parametrize("cross_lane", [False, True])
def test_flow_update_kernel_is_bit_exact(cuda, p, f, segments, cross_lane):
    """One launch a call, no op on the card but the output's allocation
    (no sort), the input table left as it was, bit for bit with the twin."""
    gen = torch.Generator().manual_seed(p + f + int(cross_lane))
    args = [a.to(cuda) for a in _flow_args(gen, p, f, segments, cross_lane)]
    table = args[3].clone()
    before = ff.FLOW_UPDATE.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = ff.flow_feature_update(*args)
    assert ff.FLOW_UPDATE.launches == before + 1
    ops = {e.key for e in prof.key_averages() if e.key.startswith("aten::")}
    assert ops <= {"aten::empty_like", "aten::empty", "aten::empty_strided"}, ops
    assert torch.equal(args[3], table)
    assert torch.equal(out, ff.flow_feature_update_plain(*args))


@pytest.mark.parametrize("ctas,cap", [(1, FLOW_CAP), (7, 16), (128, 64), (500, FLOW_CAP),
                                      (8192, 1), (3, 8192)])
@pytest.mark.parametrize("segments", ["spread", "colliding"])
def test_flow_update_kernel_takes_any_plan(cuda, ctas, cap, segments):
    """The launcher runs any grid and chunk it is given (a cap under P with
    the chunked variant), all bit for bit with the twin."""
    gen = torch.Generator().manual_seed(ctas + cap)
    p, f = 1024, 8192
    program, slots, meta, table = (a.to(cuda) for a in _flow_args(gen, p, f, segments, True))
    out = torch.empty_like(table)
    ff.FLOW_UPDATE(cuda, program.data_ptr(), slots.data_ptr(), meta.data_ptr(), table.data_ptr(),
                   out.data_ptr(), p, f, ff.META_WIDTH, ctas, cap, p > cap, stream_of(out))
    assert torch.equal(out, ff.flow_feature_update_plain(program, slots, meta, table))


@pytest.mark.parametrize("p", [0, 1, 1024, FLOW_CAP])
@pytest.mark.parametrize("segments", ["spread", "colliding"])
def test_flow_update_chunked_variant_runs_one_chunk(cuda, p, segments):
    """The chunked variant on a batch of one chunk (P <= cap), as the plan's
    grid at the pipeline's table gives it, is bit for bit with the twin."""
    gen = torch.Generator().manual_seed(p)
    f = 8192
    program, slots, meta, table = (a.to(cuda) for a in _flow_args(gen, p, f, segments, True))
    plan, out = ff.flow_plan(p, f), torch.empty_like(table)
    assert plan.variant == "single"
    ff.FLOW_UPDATE(cuda, program.data_ptr(), slots.data_ptr(), meta.data_ptr(), table.data_ptr(),
                   out.data_ptr(), p, f, ff.META_WIDTH, plan.ctas, plan.cap, True,
                   stream_of(out))
    assert torch.equal(out, ff.flow_feature_update_plain(program, slots, meta, table))


@pytest.mark.parametrize("segments", ["spread", "one"])
def test_flow_update_copies_an_unaligned_table(cuda, segments):
    """A table view 4 bytes into its storage takes the kernel's 4-byte copy;
    bit for bit, the storage around it untouched."""
    gen = torch.Generator().manual_seed(7)
    p, f = 1024, 1000
    program, slots, meta, table = _flow_args(gen, p, f, segments, True)
    flat = torch.cat([torch.tensor([5], dtype=torch.int32), table.flatten()]).to(cuda)
    view = flat[1:].view(f, 16)
    assert view.data_ptr() % 16 == 4
    args = [a.to(cuda) for a in (program, slots, meta)] + [view]
    out = ff.flow_feature_update(*args)
    assert torch.equal(out, ff.flow_feature_update_plain(*args))
    assert flat[0].item() == 5 and torch.equal(view.cpu(), table)


@pytest.mark.parametrize("ctas,cap", [(128, 3), (128, 16384), (0, FLOW_CAP), (1, 2**13)])
def test_flow_update_launcher_refuses_what_it_cannot_run(cuda, ctas, cap):
    """A cap that is no power of two or past 8192 keys, no CTA, or rows whose
    keys would reach the sort's pad (F 2^20 on one CTA at cap 8192) raise."""
    f = 2**20 if ctas == 1 else 8192
    table = torch.zeros(f, 16, dtype=torch.int32, device=cuda)
    args = [a.to(cuda) for a in (ff.default_program("cpu"), torch.zeros(4, dtype=torch.int32),
                                 torch.zeros(4, 13, dtype=torch.int32))]
    before = ff.FLOW_UPDATE.launches
    with pytest.raises(RuntimeError, match="flow_update_launch"):
        ff.FLOW_UPDATE(cuda, *(a.data_ptr() for a in args), table.data_ptr(), table.data_ptr(),
                       4, f, ff.META_WIDTH, ctas, cap, True, stream_of(table))
    assert ff.FLOW_UPDATE.launches == before


@pytest.mark.parametrize("p,cap", [(17, 16), (FLOW_CAP + 1, FLOW_CAP)])
def test_flow_update_launcher_refuses_single_past_the_cap(cuda, p, cap):
    """The single variant folds one chunk, so a batch past the cap given to
    it raises instead of dropping packets."""
    f = 8192
    args = [a.to(cuda) for a in _flow_args(torch.Generator().manual_seed(p), p, f, "spread",
                                          False)]
    out = torch.empty_like(args[3])
    before = ff.FLOW_UPDATE.launches
    with pytest.raises(RuntimeError, match="flow_update_launch"):
        ff.FLOW_UPDATE(cuda, *(a.data_ptr() for a in args), out.data_ptr(), p, f, ff.META_WIDTH,
                       256, cap, False, stream_of(out))
    assert ff.FLOW_UPDATE.launches == before


# vpe_mm_q's rows: one, both sides of a 256-row count, and conv1's 5120
VPE_Q_ROWS = [1, 255, 257, 5120]
VPE_Q_COLS = [1, 2, 3, 6, 12, 31, 32, 33, 64, 128, 162]


@pytest.mark.parametrize("m", VPE_Q_ROWS)
@pytest.mark.parametrize("per_channel", [False, True], ids=["tensor", "channel"])
@pytest.mark.parametrize("act", ["none", "relu", "silu", "gelu"])
def test_vpe_int8_kernel_is_bit_exact_at_every_small_shape(cuda, m, per_channel, act):
    """K 1-12 by N 1-162: one launch each, bit for bit with the twin under
    none/relu; under silu/gelu the pre-activation is bit for bit (the none
    arm) and the activation's exp/tanh, which differ between the kernel and
    torch, within rtol 1e-5."""
    gen = torch.Generator().manual_seed(m)
    for k in range(1, 13):
        for n in VPE_Q_COLS:
            x = (torch.randn(m, k, generator=gen) * 3).to(cuda)
            w = torch.randn(k, n, generator=gen).to(cuda)
            sx = pick_scale(x.abs().max().item())
            sw = (tuple(pick_scale(v) for v in w.abs().amax(0).tolist()) if per_channel
                  else pick_scale(w.abs().max().item()))
            before = VPE_MM_Q.launches
            out = vpe_matmul_q(x, w, scale_x=sx, scale_w=sw, activation=act)
            assert VPE_MM_Q.launches == before + 1
            ref = vpe_mm_q(x, w, scale_x=sx, scale_w=sw, activation=act)
            if act in ("none", "relu"):
                assert torch.equal(out, ref), (k, n)
            else:
                pre = vpe_matmul_q(x, w, scale_x=sx, scale_w=sw)
                assert torch.equal(pre, vpe_mm_q(x, w, scale_x=sx, scale_w=sw)), (k, n)
                torch.testing.assert_close(out, ref, rtol=1e-5,
                                           atol=1e-5 * ref.abs().max().item())


@pytest.mark.parametrize("engine,plain", [(vpe_matmul_q, vpe_mm_q), (arype_matmul_q, mm_fused_q)])
@pytest.mark.parametrize("m,k,n", [(1024, 6, 12), (5120, 3, 32), (257, 12, 162), (256, 96, 128)])
@pytest.mark.parametrize("per_channel", [False, True], ids=["tensor", "channel"])
def test_int8_kernels_round_ties_to_even(cuda, engine, plain, m, k, n, per_channel):
    """Inputs on the codes' .5 ties, (c + 0.5) * s for c in [-130, 130) (past
    the clip too): the IEEE quotient lands on or next to the tie, where
    rounding half to even and the clip decide the code; bit for bit."""
    gen = torch.Generator().manual_seed(m + k + n)
    sx = 0.037
    sw = tuple(0.01 + 0.001 * j for j in range(n)) if per_channel else 0.021
    codes = lambda *shape: torch.randint(-130, 130, shape, generator=gen).float() + 0.5
    x = (codes(m, k) * sx).to(cuda)
    w = (codes(k, n) * torch.tensor(sw, dtype=torch.float32).expand(n)).to(cuda)
    for act in ("none", "relu"):
        assert torch.equal(engine(x, w, scale_x=sx, scale_w=sw, activation=act),
                           plain(x, w, scale_x=sx, scale_w=sw, activation=act))


@pytest.mark.parametrize("bm,bn,bk", [(7, 12, 6), (1, 1, 1), (8, 256, 160), (2048, 1, 3)])
def test_vpe_int8_kernel_takes_any_tile(cuda, bm, bn, bk):
    """The launcher runs any tile within its limits (K in steps, N in column
    tiles), bit for bit; one past them (2049 outputs a CTA) raises."""
    gen = torch.Generator().manual_seed(bm + bn + bk)
    m, k, n = 1000, 300, 163
    x = (torch.randn(m, k, generator=gen) * 3).to(cuda)
    w = torch.randn(k, n, generator=gen).to(cuda)
    sx, sw = pick_scale(x.abs().max().item()), tuple(pick_scale(v) for v in w.abs().amax(0).tolist())
    out = torch.empty(m, n, device=cuda)
    f32 = DTYPES[torch.float32]
    launch = lambda *tile: VPE_MM_Q(cuda, x.data_ptr(), w.data_ptr(), sx,
                                    scale_row(sw, n, cuda).data_ptr(), out.data_ptr(), m, k, n,
                                    0, *tile, f32, f32, f32, stream_of(x))
    launch(bm, bn, bk)
    assert torch.equal(out, vpe_mm_q(x, w, scale_x=sx, scale_w=sw))
    with pytest.raises(RuntimeError, match="vpe_mm_q_launch"):
        launch(2048 // bn + 1, bn, bk)


def test_pipeline_on_card_matches_cpu(cuda):
    mlp = init_paper_model("mlp", torch.Generator().manual_seed(1), device="cpu")
    cnn = init_paper_model("cnn", torch.Generator().manual_seed(2), device="cpu")
    cfg = PipelineConfig(batch_size=256, max_ready=64, table_size=1024)
    gpu = OctopusPipeline(mlp, cnn, cfg)
    cpu = OctopusPipeline(mlp, cnn, cfg, device="cpu")
    gen = TrafficGenerator(TrafficConfig(batch_size=256, active_flows=64, table_size=1024,
                                         elephant_fraction=0.5), device="cpu")
    kernels.reset_launches()
    for _ in range(12):
        batch = gen.next_batch()
        out_g = gpu.step(ft.PacketBatch(*(a.to(cuda) for a in batch)))
        out_c = cpu.step(batch)
        for a, b in zip(gpu.state, cpu.state):
            assert torch.equal(a.cpu(), b)
        for a, b in zip(out_g.drained, out_c.drained):
            assert torch.equal(a.cpu(), b)
    counts = kernels.launches()
    assert all(counts[name] > 0 for name in ("flow_update", "vpe_mm", "mm_fused"))
    assert counts["vpe_mm_q"] == counts["mm_fused_q"] == 0  # the f32 path
    assert np.isfinite(gpu.stats.step_us)


def test_int8_pipeline_on_card_matches_cpu(cuda):
    mlp = init_paper_model("mlp", torch.Generator().manual_seed(1), device="cpu")
    cnn = init_paper_model("cnn", torch.Generator().manual_seed(2), device="cpu")
    table = calibrate_quant_scales(mlp, cnn, max_flip_rate=None, device="cpu")
    runtime = RuntimeConfig(quantize=True, quant_scales=table)
    cfg = PipelineConfig(batch_size=256, max_ready=64, table_size=1024)
    gpu = OctopusPipeline(mlp, cnn, cfg, config=runtime)
    cpu = OctopusPipeline(mlp, cnn, cfg, config=runtime, device="cpu")
    gen = TrafficGenerator(TrafficConfig(batch_size=256, active_flows=64, table_size=1024,
                                         elephant_fraction=0.5), device="cpu")
    steps, counts = 12, dict.fromkeys(kernels.launches(), 0)
    for _ in range(steps):
        batch = gen.next_batch()
        batch_g = ft.PacketBatch(*(a.to(cuda) for a in batch))
        kernels.reset_launches()
        out_g = gpu.step(batch_g)
        counts = {name: counts[name] + n for name, n in kernels.launches().items()}
        out_c = cpu.step(batch)
        for a, b in zip(gpu.state, cpu.state):
            assert torch.equal(a.cpu(), b)
        for a, b in zip(out_g.drained, out_c.drained):
            assert torch.equal(a.cpu(), b)
        # integer-valued packet features: the int8 packet logits agree bit for bit
        logits_g = gpu.packet_engine.fn(gpu.packet_engine.params, packet_meta_features(batch_g))
        logits_c = cpu.packet_engine.fn(cpu.packet_engine.params, packet_meta_features(batch))
        assert torch.equal(logits_g.cpu(), logits_c)
        # both engines given the CPU's flow-model input: int8 flow logits bit for bit
        flow_x = cpu.flow_engine.prep(out_c.drained.series, None)
        flow_g = gpu.flow_engine.fn(gpu.flow_engine.params, flow_x.to(cuda))
        assert torch.equal(flow_g.cpu(), cpu.flow_engine.fn(cpu.flow_engine.params, flow_x))
    # the pipeline's own launches per step: w0..w3 and conv1..conv3 on the VPE
    # (conv2/conv3 fit its working-set limit at max_ready 64), fc and linear
    # on the AryPE; every engine layer int8
    want = dict.fromkeys(counts, 0)
    want.update(flow_update=steps, vpe_mm_q=7 * steps, mm_fused_q=2 * steps)
    assert counts == want


@pytest.mark.parametrize("policy", ["age", "lru"])
def test_cold_store_on_card_matches_cpu(cuda, policy):
    """promote, merge with spills, apply spills and scrub on the card against
    the CPU, bit for bit, on a storm whose records share cold slots; the
    card's cold leaves keep their storage."""
    from repro_torch.core import cold_store as cs
    from repro_torch.core.feature_extractor import segmented_update

    F, C = 16, 13
    states = {dev: cs.init_two_level(F, C, 4, 3, 4, device=dev) for dev in ("cpu", cuda)}
    ptrs = [leaf.data_ptr() for leaf in states[cuda].cold]
    rng = np.random.default_rng(7)
    tuples = rng.integers(1, 10_000, size=40)
    clock = 0
    for rnd in range(10):
        ts = clock + np.cumsum(rng.integers(1, 30, size=32))
        clock = int(ts[-1])
        leaves = [ts, rng.integers(40, 1500, 32), rng.integers(0, 2, 32), rng.integers(0, 64, 32),
                  rng.integers(0, 3, 32), rng.choice(tuples, size=32), rng.integers(0, 256, (32, 4))]
        keep = torch.as_tensor(rng.random(32) < 0.8)
        for dev in ("cpu", cuda):
            batch = ft.PacketBatch(*(torch.as_tensor(np.asarray(a, np.int32), device=dev)
                                     for a in leaves))
            k = keep.to(dev)
            hot, cold, _ = cs.promote_pass(*states[dev], batch, k, policy=policy)
            hot, _, spills = segmented_update(hot, batch, top_n=4, keep=k, with_spills=True)
            cold, _ = cs.apply_spills(cold, spills, policy=policy)
            states[dev] = cs.TwoLevelState(hot, cs.scrub_live(cold, hot, batch, k))
        for level in ("hot", "cold"):
            for a, b in zip(getattr(states[cuda], level), getattr(states["cpu"], level)):
                assert torch.equal(a.cpu(), b), (rnd, level)
    assert int(cs.cold_occupancy(states[cuda].cold)) > 0
    assert [leaf.data_ptr() for leaf in states[cuda].cold] == ptrs


def test_overlapped_chunked_two_level_pipeline_on_card_matches_eager(cuda):
    """scan_len 4 with overlap on the card ends where the eager card loop
    does (hot and cold leaves, rules, counters) and where the CPU does
    (leaves, counters)."""
    from repro_torch.data.traffic import prefetch

    mlp = init_paper_model("mlp", torch.Generator().manual_seed(1), device="cpu")
    cnn = init_paper_model("cnn", torch.Generator().manual_seed(2), device="cpu")
    shape = dict(batch_size=256, max_ready=64, table_size=256, cold_size=4096)
    gen = TrafficGenerator(TrafficConfig(batch_size=256, active_flows=2048, table_size=256,
                                         collision_free=False), device="cpu")
    batches = [gen.next_batch() for _ in range(12)]
    pipes = [OctopusPipeline(mlp, cnn, PipelineConfig(**shape)),
             OctopusPipeline(mlp, cnn, PipelineConfig(**shape, scan_len=4, overlap=True)),
             OctopusPipeline(mlp, cnn, PipelineConfig(**shape), device="cpu")]
    pipes[0].run(batches, steps=12)
    pipes[1].run(prefetch(iter(batches)), steps=12)
    pipes[2].run(batches, steps=12)
    for pipe in pipes[1:]:
        for level in ("hot", "cold"):
            for a, b in zip(getattr(pipes[0].state, level), getattr(pipe.state, level)):
                assert torch.equal(a.cpu(), b.cpu())
        if pipe.device.type == "cuda":  # the CPU may decide near ties otherwise
            assert pipe.rules.rules == pipes[0].rules.rules
        assert (pipe.stats.spilled, pipe.stats.promoted) == (pipes[0].stats.spilled,
                                                             pipes[0].stats.promoted)
    assert pipes[0].stats.spilled > 0 and pipes[0].stats.promoted > 0
    assert pipes[1].stats.dispatches == 3


def _decisions_agree(cpu, out_g, out_c, batch):
    """Packet verdicts equal except where the CPU's logits are a near tie."""
    logits = cpu.packet_engine.fn(cpu.packet_engine.params, packet_meta_features(batch))
    tie = (logits[:, 1] - logits[:, 0]).abs() < 1e-4
    assert not ((out_g.pkt_actions.cpu() != out_c.pkt_actions) & ~tie).any()


@pytest.mark.parametrize("lane_batch,cold", [(None, 0), (48, 2048)], ids=["lockstep", "rounds"])
def test_sharded_step_on_card_matches_cpu(cuda, lane_batch, cold):
    """4 lanes on the card against the CPU port: the (S, F, ...) state (and
    the cold lanes with their clocks), drained rows and counters bit for bit
    every step; one ``flow_update`` a round whatever the lanes."""
    from repro_torch.serving import ShardedOctopusPipeline

    mlp = init_paper_model("mlp", torch.Generator().manual_seed(1), device="cpu")
    cnn = init_paper_model("cnn", torch.Generator().manual_seed(2), device="cpu")
    cfg = PipelineConfig(batch_size=256, max_ready=64, table_size=256, cold_size=cold,
                         cold_policy="lru")
    kw = dict(num_shards=4, lane_batch=lane_batch)
    gpu = ShardedOctopusPipeline(mlp, cnn, cfg, device=cuda, **kw)
    cpu = ShardedOctopusPipeline(mlp, cnn, cfg, device="cpu", **kw)
    gen = TrafficGenerator(TrafficConfig(batch_size=256, active_flows=96 if not cold else 2048,
                                         table_size=256, elephant_fraction=0.5,
                                         collision_free=not cold), device="cpu")
    for _ in range(12):
        batch = gen.next_batch()
        kernels.reset_launches()
        out_g = gpu.step(batch)
        rounds = gpu.stats.dispatches - cpu.stats.dispatches
        assert kernels.launches()["flow_update"] == rounds
        out_c = cpu.step(batch)
        leaves = lambda s: [x for part in s for x in (part if isinstance(part, tuple) else [part])]
        for a, b in zip(leaves(gpu.state), leaves(cpu.state)):
            assert torch.equal(a.cpu(), b)
        for a, b in zip(out_g.drained, out_c.drained):
            assert torch.equal(a.cpu(), b)
        for name in ("new_flows", "evicted", "spilled", "promoted"):
            assert int(getattr(out_g, name)) == int(getattr(out_c, name))
        _decisions_agree(cpu, out_g, out_c, batch)
    assert gpu.stats.flows == cpu.stats.flows
    if cold:  # 2048 flows on 4 x 256 slots: they spill and return, few drain
        assert gpu.stats.spilled > 0 and gpu.stats.promoted > 0 and gpu.stats.dispatches > 12
    else:
        assert gpu.stats.flows > 0


def test_service_on_card_matches_cpu(cuda):
    """``OctopusService`` inline over 2 lanes on the card and on the CPU, the
    same closed-loop clients: every request's buckets equal, verdicts equal
    except near ties; pinned staging buffers on the card."""
    import asyncio

    from repro_torch.serving import OctopusService, ServiceConfig, ShardedOctopusPipeline
    from repro_torch.serving import serve_stream

    mlp = init_paper_model("mlp", torch.Generator().manual_seed(1), device="cpu")
    cnn = init_paper_model("cnn", torch.Generator().manual_seed(2), device="cpu")
    cfg = PipelineConfig(batch_size=256, max_ready=64, table_size=1024)
    sizes = (17, 100, 250, 400)
    gens = lambda: [TrafficGenerator(TrafficConfig(batch_size=n, active_flows=64, table_size=1024,
                                                   seed=i, client_id=i), device="cpu")
                    for i, n in enumerate(sizes)]

    def serve(device):
        pipe = ShardedOctopusPipeline(mlp, cnn, cfg, num_shards=2, device=device)
        svc = OctopusService(pipe, ServiceConfig(buckets=(64, 256, 512), depth_budget=4096,
                                                 offload=False))

        async def run():
            async with svc:
                return await asyncio.gather(*(serve_stream(svc, g, requests=4) for g in gens()))

        return pipe, svc, asyncio.run(run())

    gpu, svc_g, outs_g = serve(cuda)
    cpu, svc_c, outs_c = serve("cpu")
    assert all(buf["keep"].is_pinned() for bufs in svc_g._pool._free.values() for buf in bufs)
    for gen, got, want in zip(gens(), outs_g, outs_c):
        for batch, g, w in zip(gen.batches(4), got, want):
            assert g.buckets == w.buckets
            logits = cpu.packet_engine.fn(cpu.packet_engine.params, packet_meta_features(batch))
            tie = ((logits[:, 1] - logits[:, 0]).abs() < 1e-4).numpy()
            assert not ((g.pkt_actions != w.pkt_actions) & ~tie).any()
    assert (svc_g.stats.dispatches, svc_g.stats.padded) == (svc_c.stats.dispatches,
                                                            svc_c.stats.padded)
    assert svc_g.queue_depth == 0 and svc_g.stats.served == 4 * sum(sizes)


@pytest.mark.parametrize("collision_free", [True, False], ids=["spread", "colliding"])
def test_extractor_at_twenty_chunks_matches_cpu(cuda, collision_free):
    """The offline extractor on a whole 81920-packet trace (20 of
    ``flow_update``'s chunks): the segmented merge with a keep mask, the
    extraction and the scan with the fold replayed (its dropped packets
    spread over the chunks), each against the CPU's plain fold; the replay's
    fold input against the plain fold on the card."""
    from repro_torch.core.feature_extractor import (
        ExtractorConfig,
        FeatureExtractor,
        segmented_update,
    )
    from repro_torch.data import PacketTraceConfig, synth_packet_trace

    packets, *_ = synth_packet_trace(PacketTraceConfig(
        num_flows=4096, pkts_per_flow=20, collision_free=collision_free), device="cpu")
    p = packets.ts.shape[0]
    assert ff.flow_plan(p, 8192).variant == "chunked" and -(-p // FLOW_CAP) == 20
    on_card = ft.PacketBatch(*(a.to(cuda) for a in packets))
    keep = torch.rand(p, generator=torch.Generator().manual_seed(0)) < 0.7
    devices = {"card": (FeatureExtractor(ExtractorConfig(use_pallas=True), device=cuda), on_card,
                        keep.to(cuda)),
               "cpu": (FeatureExtractor(ExtractorConfig(use_pallas=True), device="cpu"), packets,
                       keep)}
    out = {}
    for name, (ex, batch, k) in devices.items():
        kernels.reset_launches()
        out[name] = (segmented_update(ex.init_state(), batch, ex.program, top_n=20, keep=k)[0],
                     ex.extract_segmented(batch), ex.extract_scan(ex.init_state(), batch))
        if name == "card":
            assert kernels.launches()["flow_update"] == 3
    (masked_g, seg_g, (scan_g, outs_g)), (masked_c, seg_c, (scan_c, outs_c)) = out.values()
    for a, b in zip((*masked_g, *seg_g, *scan_g, *outs_g), (*masked_c, *seg_c, *scan_c, *outs_c)):
        assert torch.equal(a.cpu(), b)
    ex = devices["card"][0]
    args = (ex.program, *ex.replay_inputs(ex.init_state(), on_card, outs_g))
    assert not collision_free or int((args[1] == 8192).sum()) == 0
    assert torch.equal(ff.flow_feature_update(*args), ff.flow_feature_update_plain(*args))


@pytest.mark.parametrize("batch", [1, 8])
def test_packet_path_on_card_matches_cpu(cuda, batch):
    """``PacketPath`` at the MLP's smallest batches (``vpe_mm`` on the skinny
    split-K at K and N of 2-12): verdicts and the logits within rtol 1e-5 of
    the CPU's, four ``vpe_mm`` launches a call."""
    from repro_torch.serving import PacketPath

    mlp = init_paper_model("mlp", torch.Generator().manual_seed(1), device="cpu")
    gen = TrafficGenerator(TrafficConfig(batch_size=batch, active_flows=4, table_size=64),
                           device="cpu")
    gpu, cpu = PacketPath(mlp, device=cuda), PacketPath(mlp, device="cpu")
    gpu.warmup(batch)
    kernels.reset_launches()
    for _ in range(5):
        pk = gen.next_batch()
        feats = packet_meta_features(pk)
        want = cpu.engine.fn(cpu.params, feats)
        got = gpu.engine.fn(gpu.params, feats.to(cuda)).cpu()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())
        np.testing.assert_array_equal(gpu.process(pk), cpu.process(pk))
    assert kernels.launches()["vpe_mm"] == 5 * 4 * 2
    assert gpu.rules.rules == cpu.rules.rules and gpu.stats.calls == 5


def test_feature_only_heads_launch_no_engine_kernel(cuda):
    """A pipeline step under ``PassHead``/``TopKHead`` launches one
    ``flow_update`` and no engine kernel, and equals the CPU's step."""
    from repro_torch.core.decisions import PassHead, TopKHead

    mlp = init_paper_model("mlp", torch.Generator().manual_seed(1), device="cpu")
    cnn = init_paper_model("cnn", torch.Generator().manual_seed(2), device="cpu")
    cfg = PipelineConfig(batch_size=256, max_ready=64, table_size=1024, pkt_head=PassHead(),
                         flow_head=TopKHead())
    gpu = OctopusPipeline(mlp, cnn, cfg)
    cpu = OctopusPipeline(mlp, cnn, cfg, device="cpu")
    gen = TrafficGenerator(TrafficConfig(batch_size=256, active_flows=64, table_size=1024,
                                         elephant_fraction=0.5), device="cpu")
    gpu.warmup()
    kernels.reset_launches()
    for _ in range(12):
        batch = gen.next_batch()
        out_g, out_c = gpu.step(batch), cpu.step(batch)
        for a, b in zip((*gpu.state, *out_g.drained, out_g.flow_scores, out_g.pkt_actions),
                        (*cpu.state, *out_c.drained, out_c.flow_scores, out_c.pkt_actions)):
            assert torch.equal(a.cpu(), b)
    counts = kernels.launches()
    assert counts["flow_update"] == 12 and sum(counts.values()) == 12
    assert gpu.stats.flows > 0 and gpu.rules.rules == cpu.rules.rules


def test_smoke_calibration_on_card(cuda):
    """``autotune.calibrate`` on the card over the 8-point grid: both arms
    timed (the hand-written ``mm_fused`` and ``vpe_mm``), the fit from those
    timings, the card's fingerprint."""
    from repro_torch.runtime import autotune, fit_crossover, platform

    kernels.reset_launches()
    calib = autotune.calibrate(smoke=True, iters=2, device=cuda)
    assert len(calib.timings) == 8
    assert all(t.us_arype > 0 and t.us_vpe > 0 for t in calib.timings)
    assert (calib.tau, calib.vpe_max_elems) == fit_crossover(calib.timings)
    assert calib.backend == "cuda" and calib.fingerprint_id == platform.fingerprint_id(device=cuda)
    counts = kernels.launches()
    assert counts["mm_fused"] == counts["vpe_mm"] == 8 * 3  # warmup + 2 iters a shape


@pytest.mark.parametrize("groups", [1, 2])
def test_moe_apply_on_card_matches_cpu(cuda, groups):
    """``moe_apply`` on reduced granite (f32) and its shared-expert form
    (reduced kimi-k2): the output within rtol 1e-5 of the CPU's, the aux
    within 1e-6, the expert ids equal."""
    from repro_torch.models import layers
    from repro_torch.models.spec import init_params

    for arch in ("granite-moe-1b-a400m", "kimi-k2-1t-a32b"):
        cfg = reduced_config(get_config(arch))
        p = init_params(layers.moe_specs(cfg), torch.Generator().manual_seed(0), device="cpu")
        x = torch.randn(2, 12, cfg.d_model, generator=torch.Generator().manual_seed(1)) * 0.5
        want, aux_c = layers.moe_apply(p, x, cfg, num_groups=groups)
        got, aux_g = layers.moe_apply({k: v.to(cuda) for k, v in p.items()}, x.to(cuda), cfg,
                                      num_groups=groups)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item())
        assert abs(aux_g.item() - aux_c.item()) <= 1e-6
        h = layers.rms_norm(x, p["ln"]).reshape(groups, -1, cfg.d_model)
        ids_c = layers.moe_route(p["router"], h, cfg.experts_per_token)[2]
        ids_g = layers.moe_route(p["router"].to(cuda), h.to(cuda), cfg.experts_per_token)[2]
        assert torch.equal(ids_g.cpu(), ids_c)


# ---------------------------------------------------------------- training


@pytest.mark.parametrize("m,k,n", [(64, 96, 80), (4, 1024, 1024), (1024, 1024, 2048)])
@pytest.mark.parametrize("xt,ot,act", [(torch.float32, torch.float32, "none"),
                                       (torch.float32, torch.float32, "gelu"),
                                       (torch.bfloat16, torch.bfloat16, "silu"),
                                       (torch.bfloat16, torch.float32, "relu")],
                         ids=["f32", "f32-gelu", "bf16-silu", "bf16x-f32out-relu"])
def test_engine_backward_equals_direct_kernel_calls(cuda, m, k, n, xt, ot, act):
    """``router.matmul``'s backward on the card: dX and dW bit for bit the
    kernel called directly on the transposed operands (and the cotangent
    pulled back through the activation at the recomputed f32 product), with
    one launch a product: the forward, the recompute, dX, dW."""
    from repro_torch.common.util import activation_vjp
    from repro_torch.core import router

    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(m, k, generator=gen, device=cuda).to(xt)
    w = (torch.randn(k, n, generator=gen, device=cuda) * k ** -0.5).requires_grad_()
    ct = torch.randn(m, n, generator=gen, device=cuda).to(ot)
    x.requires_grad_()
    cfg = RuntimeConfig(policy="arype_only")
    kernels.reset_launches()
    out = router.matmul(x, w, activation=act, out_dtype=ot, config=cfg)
    out.backward(ct)
    torch.cuda.synchronize()
    assert kernels.launches()["mm_fused"] == 3 + (act != "none")
    with torch.no_grad():
        assert torch.equal(out, arype_matmul(x, w, activation=act, out_dtype=ot))
        g = ct.float()
        if act != "none":
            g = activation_vjp(arype_matmul(x, w, out_dtype=torch.float32), g, act)
        assert torch.equal(x.grad, arype_matmul(g, w.t().contiguous(), out_dtype=xt))
        assert torch.equal(w.grad, arype_matmul(x.t().contiguous(), g, out_dtype=torch.float32))


@pytest.mark.parametrize("kind,window,hkv", [("causal", 0, 2), ("local", 48, 1), ("full", 0, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_backward_on_card_matches_cpu(cuda, kind, window, hkv, dtype):
    """dq, dk, dv of the training attention (``flash_fwd`` forward, the
    plain reference arm's backward) on the card against the CPU: f32 within
    rtol 1e-4, atol 1e-5 of max|grad|; bf16 within two bf16 steps of max."""
    from repro_torch.models import layers

    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 160, h, 128, generator=gen).to(dtype) for h in (4, hkv, hkv))
    ct = torch.randn(2, 160, 4, 128, generator=gen).to(dtype)
    grads = []
    for dev in ("cpu", cuda):
        leaves = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        kernels.reset_launches()
        layers.attention_train(*leaves, kind=kind, window=window).backward(ct.to(dev))
        grads.append([t.grad.float().cpu() for t in leaves])
    assert kernels.launches()["flash_fwd"] == 1
    for name, want, got in zip("qkv", *grads):
        top = want.abs().max().item()
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * top, msg=name)
        else:
            assert (got - want).abs().max().item() <= 2 * 2.0 ** -8 * top, name


def test_train_step_on_card_matches_cpu(cuda):
    """One train step of reduced qwen3-0.6b (AdamW) from the same params on
    the card and on the CPU: the loss within rtol 1e-5, each gradient leaf
    within 1e-4 of its max|grad|; the card's updated parameters and moments
    within 1e-4 of their leaf's max|value| of the CPU's AdamW applied to the
    card's own gradients (AdamW's first step divides each gradient by its
    magnitude plus 1e-8, which magnifies last-bit differences of gradients
    near 1e-8); and the launches of a step: each forward matmul once, each
    silu gate again (the recompute), dX and dW each, one ``flash_fwd`` a
    layer."""
    from repro_torch.optim import clip_by_global_norm, make_optimizer
    from repro_torch.train.steps import grads_of, make_train_step

    cfg = reduced_config(get_config("qwen3-0.6b")).replace(router_policy="arype_only")
    params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (4, 33), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1].int(), "labels": toks[:, 1:].int()}
    b = {k: v.to(cuda) for k, v in batch.items()}
    grads, metrics = grads_of(_tree_to(params, cuda), cfg, b)
    cpu_grads, cpu_metrics = grads_of(_tree_to(params, "cpu"), cfg, batch)
    assert abs(float(metrics["loss"]) - float(cpu_metrics["loss"])) <= \
        1e-5 * abs(float(cpu_metrics["loss"]))
    opt = make_optimizer("adamw", 1e-2)
    p = _tree_to(params, cuda)
    kernels.reset_launches()
    p, state, _ = make_train_step(cfg, opt)(p, opt.init(p), 0, b)
    counts = kernels.launches()
    forward = 7 * cfg.num_superblocks + 1  # wq wk wv wo, gate up down; the head
    assert counts["mm_fused"] == 3 * forward + cfg.num_superblocks
    assert counts["flash_fwd"] == cfg.num_superblocks
    on_cpu = _tree_to(params, "cpu")
    on_cpu, cpu_state = opt.update(clip_by_global_norm(_tree_to(grads, "cpu"), 1.0)[0],
                                   opt.init(on_cpu), on_cpu, 0)
    pairs = [(tree_items(grads), tree_items(cpu_grads)),
             (tree_items({"p": p, "s": state}), tree_items({"p": on_cpu, "s": cpu_state}))]
    for got_items, want_items in pairs:
        for (key, got), (_, want) in zip(got_items, want_items):
            top = want.abs().max().item()
            assert (got.cpu() - want).abs().max().item() <= 1e-4 * max(top, 1e-30), key


def _tree_to(tree, dev):
    """A copy of a tree of tensors (dicts, NamedTuples) on ``dev``."""
    return tree_map(lambda t: t.detach().to(dev, copy=True), tree)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-1b-a400m"])
def test_forward_without_grad_launches_and_computes_as_before(cuda, arch):
    """With no grad required the forward takes no autograd path: the same
    launches and the same bits whether or not the parameters require grad
    under ``torch.no_grad``, and the training forward with grad gives the
    same logits too."""
    cfg = reduced_config(get_config(arch)).replace(compute_dtype="bfloat16")
    model = LM(cfg, device=cuda)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 24), device=cuda, dtype=torch.int32)
    runs = []
    for live in (False, True):
        p = _tree_to(params, cuda)
        if live:
            for _, leaf in tree_items(p):
                leaf.requires_grad_()
        for grad in (False, True) if live else (False,):
            kernels.reset_launches()
            with torch.set_grad_enabled(grad):
                logits, _ = model.forward(p, {"tokens": toks})
            torch.cuda.synchronize()
            runs.append((logits.detach(), kernels.launches(), logits.requires_grad))
    base = runs[0]
    assert not base[2] and not runs[1][2] and runs[2][2]
    for logits, counts, _ in runs[1:]:
        assert torch.equal(logits, base[0]) and counts == base[1]


# zamba2-2.7b's in_proj: N 10448 is a multiple of neither 128 nor 32, so the
# tiles at the right edge are ragged; 4 rows (a 4-slot decode) and one
# (batch 1), both the skinny variant, and a 4-slot prefill's rows
@pytest.mark.parametrize("m", [4, 1, 180])
def test_mixed_arm_at_zamba2_in_proj_edge_tiles(cuda, m):
    """bf16 x on f32 w at (M, 2560, 10448): bit for bit the f32 kernel on
    x.float() rounded once, within one bf16 step of the plain twin, under
    every activation."""
    gen = torch.Generator().manual_seed(m)
    x, w = _bf16(gen, m, 2560).to(cuda), torch.randn(2560, 10448, generator=gen).to(cuda)
    for act in ("none", "relu", "silu", "gelu"):
        got = arype_matmul(x, w, activation=act, out_dtype=torch.bfloat16)
        assert torch.equal(got, arype_matmul(x.float(), w, activation=act).to(torch.bfloat16))
        ref = mm_fused(x, w, activation=act, out_dtype=torch.bfloat16).float()
        step = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0**-126))) - 7)
        assert ((got.float() - ref).abs() <= step + 1e-5 * ref.abs().max()).all(), act


@pytest.mark.parametrize("b,s", [(4, 300), (4, 45), (1, 300), (1, 45)])
def test_flash_bf16_at_head_dim_80_reads_and_writes_no_padding(cuda, b, s):
    """zamba2's shared attention: bf16, 32 heads, D 80 in the 128-wide tile,
    causal.  Within one bf16 step of the plain twin and of SDPA on the f32
    upcast inputs; on views into rows of 128 columns that hold NaN past D,
    into an output view of such rows: the dense call's bits, and the NaN
    columns of the output untouched."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa

    d, h = 80, 32
    plan = fa.flash_plan(d, torch.bfloat16)
    assert plan.width == 128
    gen = torch.Generator().manual_seed(b * s)
    wide = torch.full((3, b, s, h, plan.width), float("nan"), dtype=torch.bfloat16, device=cuda)
    wide[..., :d] = _bf16(gen, 3, b, s, h, d).to(cuda)
    q, k, v = (t[..., :d].transpose(1, 2) for t in wide)
    dense = flash_attention(*(t.contiguous() for t in (q, k, v)))
    plain = flash_attention_plain(*(t.contiguous() for t in (q, k, v)))
    exact = F.scaled_dot_product_attention(*(t.float() for t in (q, k, v)), is_causal=True)
    for ref in (plain.float(), exact):
        torch.testing.assert_close(dense.float(), ref, rtol=2.0**-7, atol=1e-5)
    out_wide = torch.full((b, s, h, plan.width), float("nan"), dtype=torch.bfloat16, device=cuda)
    out = out_wide[..., :d].transpose(1, 2)
    fa.FLASH_FWD(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, b, h, h,
                 s, s, d, *(st for t in (q, k, v, out) for st in t.stride()[:3]),
                 fa.MASKS["causal"], 0, s, 1.0 / (d ** 0.5), plan.tile, stream_of(q))
    torch.cuda.synchronize()
    assert torch.equal(out, dense)
    assert torch.isnan(out_wide[..., d:].float()).all()


# The card-vs-CPU limit of the reduced recurrent archs in f32 compute, as a
# multiple of what a one-ulp change of the embedding moves the CPU's own
# logits (``tests/test_torch_hybrid_lm.py`` holds the port to the reference
# the same way, at 3): the card sums every f32 product in another order, an
# ulp in every operation of every layer, not one at the input.  Read on an
# H100 80GB HBM3 at 700 W: 3.09 (reduced xlstm) and 0.34 (reduced zamba2);
# the limit leaves about twice the larger.
CARD_CONDITIONING = 6


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-2.7b"])
def test_recurrent_arch_on_card_matches_cpu(cuda, arch, record_property):
    """Reduced xlstm-1.3b and zamba2-2.7b in f32 compute, card against CPU
    from the same weights: prefill and 3 decode steps, the logits and every
    f32 cache leaf within max(1e-5, ``CARD_CONDITIONING`` times what a
    one-ulp change of the embedding moves the CPU's own) of their max,
    zamba2's decode steps and final cache within 2e-3 at least (they read
    its bf16 KV cache), that cache within one bf16 step, positions exact,
    leaf types equal; launches as the model code counts them (every
    projection on ``mm_fused``; zamba2's shared attention one ``flash_fwd``
    a prefill).  Records the prefill's distance over the move."""
    cfg = reduced_config(get_config(arch)).replace(router_policy="arype_only")
    params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 19), generator=torch.Generator().manual_seed(1))

    def run(dev, p, fed=None):
        """Logits of the prefill and each decode step, and the last cache;
        the decode steps take the ``fed`` tokens, else their own argmax."""
        m = LM(cfg, device=dev)
        logits, cache = m.prefill(p, {"tokens": toks.to(dev)}, m.init_cache(2, 32))
        outs = [logits]
        for i in range(3):
            nxt = (outs[-1][:, -1, :cfg.vocab_size].argmax(-1, keepdim=True) if fed is None
                   else fed[i].to(dev))
            logits, cache = m.decode_step(p, {"tokens": nxt}, cache)
            outs.append(logits)
        return outs, cache

    cpu, cpu_cache = run("cpu", params)
    fed = [o[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True) for o in cpu[:3]]
    nudged, _ = run("cpu", dict(params, embed=params["embed"] * (1 + 2.0**-23)), fed)
    moved = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(nudged, cpu))
    tol = max(1e-5, CARD_CONDITIONING * moved)
    # decode attends zamba2's bf16 KV cache, where a last-bit difference of an
    # f32 key can round it to the neighbouring bf16 value: from there on the
    # limit is tests/test_torch_lm.py's for decode from a device's own cache
    after = max(tol, 2e-3) if arch.startswith("zamba2") else tol
    kernels.reset_launches()
    card, card_cache = run(cuda, _tree_to(params, cuda), fed)
    torch.cuda.synchronize()
    counts = kernels.launches()
    per_forward = {"xlstm-1.3b": 2 * 8 * cfg.num_superblocks + 1,
                   "zamba2-2.7b": (2 * 5 + 7) * cfg.num_superblocks + 1}[arch]
    assert counts["mm_fused"] == 4 * per_forward
    assert counts["flash_fwd"] == (cfg.num_superblocks if arch.startswith("zamba2") else 0)
    over = []  # the distances held at tol, over the move
    for i, (a, b) in enumerate(zip(card, cpu)):
        limit = tol if i == 0 else after
        assert (a.cpu() - b).abs().max().item() <= limit * b.abs().max().item(), i
        if limit == tol:
            over.append((a.cpu() - b).abs().max().item() / b.abs().max().item() / moved)
    for (key, a), (_, b) in zip(tree_items(card_cache), tree_items(cpu_cache)):
        a = a.cpu()
        assert a.dtype == b.dtype, key
        if b.dtype == torch.float32:
            scale = max(b.abs().max().item(), 1e-30)
            assert (a - b).abs().max().item() <= after * scale, key
            if after == tol:
                over.append((a - b).abs().max().item() / scale / moved)
        elif b.dtype == torch.bfloat16:
            torch.testing.assert_close(a.float(), b.float(), rtol=2.0**-7,
                                       atol=1e-5 * b.float().abs().max().item())
        else:
            assert torch.equal(a, b), key
    record_property("over_move", max(over))


# llama-3.2-vision-90b's cross attention: 64 heads over 8 (GQA 8), D 128,
# every query against the 1600 image keys (the full mask): Sq = 1 (a decode
# step: one live row of a 64-row query tile) and 300 (a prefill)
CROSS_HEADS, CROSS_KV_HEADS, CROSS_KEYS = 64, 8, 1600


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq", [(4, 1), (1, 1), (4, 300)])
def test_flash_at_the_cross_shapes_matches_plain(cuda, dtype, b, sq):
    """``flash_fwd`` at the cross-attention shapes, q, k, v strided views of
    (B, S, H, D) as the LM hands them over: one launch, against the plain
    twin (f32: rtol = atol 2e-5; bf16: one bf16 step, atol 1e-5) and
    against SDPA on the f32 upcast inputs within the same tolerance."""
    import torch.nn.functional as F

    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(b * 1000 + sq)
    d = 128

    def rand(h, s):
        return torch.randn(b, s, h, d, generator=gen).to(cuda, dt).transpose(1, 2)

    q, k, v = rand(CROSS_HEADS, sq), rand(CROSS_KV_HEADS, CROSS_KEYS), rand(CROSS_KV_HEADS,
                                                                            CROSS_KEYS)
    before = kernels.launches()["flash_fwd"]
    out = flash_attention(q, k, v, mask="full")
    assert kernels.launches()["flash_fwd"] == before + 1
    plain = flash_attention_plain(q, k, v, mask="full")
    exact = F.scaled_dot_product_attention(*(t.float() for t in (q, k, v)), enable_gqa=True)
    rtol, atol = (2e-5, 2e-5) if dtype == "float32" else (2.0**-7, 1e-5)
    for ref in (plain.float(), exact):
        torch.testing.assert_close(out.float(), ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("b,s", [(2, 333), (4, 500)])
def test_flash_full_mask_at_head_dim_80_reads_and_writes_no_padding(cuda, b, s):
    """hubert-xlarge's attention: bf16, 16 heads, D 80 in the 128-wide tile,
    the full mask (bidirectional), at a ragged S 333 and at S 500.  Within
    one bf16 step of the plain twin and of SDPA on the f32 upcast inputs; on
    views into rows of 128 columns that hold NaN past D, into an output view
    of such rows: the dense call's bits, the NaN columns untouched."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa

    d, h = 80, 16
    plan = fa.flash_plan(d, torch.bfloat16)
    assert plan.width == 128
    gen = torch.Generator().manual_seed(b * s)
    wide = torch.full((3, b, s, h, plan.width), float("nan"), dtype=torch.bfloat16, device=cuda)
    wide[..., :d] = _bf16(gen, 3, b, s, h, d).to(cuda)
    q, k, v = (t[..., :d].transpose(1, 2) for t in wide)
    dense = flash_attention(*(t.contiguous() for t in (q, k, v)), mask="full")
    plain = flash_attention_plain(*(t.contiguous() for t in (q, k, v)), mask="full")
    exact = F.scaled_dot_product_attention(*(t.float() for t in (q, k, v)))
    for ref in (plain.float(), exact):
        torch.testing.assert_close(dense.float(), ref, rtol=2.0**-7, atol=1e-5)
    out_wide = torch.full((b, s, h, plan.width), float("nan"), dtype=torch.bfloat16, device=cuda)
    out = out_wide[..., :d].transpose(1, 2)
    fa.FLASH_FWD(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, b, h, h,
                 s, s, d, *(st for t in (q, k, v, out) for st in t.stride()[:3]),
                 fa.MASKS["full"], 0, s, 1.0 / (d ** 0.5), plan.tile, stream_of(q))
    torch.cuda.synchronize()
    assert torch.equal(out, dense)
    assert torch.isnan(out_wide[..., d:].float()).all()


def _frontend_batch(cfg, b: int, s: int, gen) -> dict:
    """A batch of the arch's inputs: ``frames`` or ``tokens``, and ``vision``
    under ``vision_patches``, f32 normal embeddings."""
    batch = {}
    if cfg.frontend == "audio_frames":
        batch["frames"] = torch.randn(b, s, cfg.d_model, generator=gen)
    else:
        batch["tokens"] = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
    if cfg.frontend == "vision_patches":
        batch["vision"] = torch.randn(b, cfg.num_image_tokens, cfg.d_model, generator=gen)
    return batch


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "hubert-xlarge"])
def test_frontend_arch_on_card_matches_cpu(cuda, arch, record_property):
    """Reduced llama-3.2-vision-90b and hubert-xlarge in f32 compute, card
    against CPU from the same weights and inputs: hubert's forward and
    prefill of 19 frames; llama's forward, prefill of 16 tokens and 3 decode
    steps fed the CPU's tokens (the cross layers' keys from the prefill's
    image rows).  Logits and every f32 cache leaf within max(1e-5,
    ``CARD_CONDITIONING`` times what a one-ulp change of the input (the
    embedding table, or the frames) moves the CPU's own), llama's decode
    steps within 2e-3 at least (they read the bf16 self-attention caches),
    those caches within one bf16 step, positions exact, leaf types equal;
    launches as the model code counts them: a prefill 7 ``mm_fused`` a
    layer (6 for hubert's gelu MLP) and the head, a llama decode step 5 in a
    cross layer; one ``flash_fwd`` an attention layer a prefill, one a
    cross layer a decode step."""
    cfg = reduced_config(get_config(arch)).replace(router_policy="arype_only")
    params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    batch = _frontend_batch(cfg, 2, 19, torch.Generator().manual_seed(1))
    decodes = 3 if cfg.supports_decode else 0
    first = {k: v if k == "vision" else v[:, :19 - decodes] for k, v in batch.items()}

    def run(dev, p, inputs, fed=None):
        """The forward's logits, the prefill's and each decode step's, and
        the last cache; the decode steps take the ``fed`` tokens, else their
        own argmax."""
        m = LM(cfg, device=dev)
        on = {k: v.to(dev) for k, v in inputs.items()}
        outs = [m.forward(p, on)[0]]
        logits, cache = m.prefill(p, {k: v if k == "vision" else v[:, :19 - decodes]
                                      for k, v in on.items()}, m.init_cache(2, 32))
        outs.append(logits)
        for i in range(decodes):
            nxt = (outs[-1][:, -1, :cfg.vocab_size].argmax(-1, keepdim=True) if fed is None
                   else fed[i].to(dev))
            logits, cache = m.decode_step(p, {"tokens": nxt}, cache)
            outs.append(logits)
        return outs, cache

    cpu, cpu_cache = run("cpu", params, batch)
    fed = [o[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True) for o in cpu[1:1 + decodes]]
    if "embed" in params:
        nudged, _ = run("cpu", dict(params, embed=params["embed"] * (1 + 2.0**-23)), batch, fed)
    else:
        nudged, _ = run("cpu", params, dict(batch, frames=batch["frames"] * (1 + 2.0**-23)), fed)
    moved = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(nudged, cpu))
    tol = max(1e-5, CARD_CONDITIONING * moved)
    after = max(tol, 2e-3)  # decode reads the bf16 self-attention caches
    kernels.reset_launches()
    card, card_cache = run(cuda, _tree_to(params, cuda), batch, fed)
    torch.cuda.synchronize()
    counts = kernels.launches()
    layers_, cross = cfg.num_layers, sum(l.mixer == "attn_cross" for l in cfg.all_layers())
    per_layer = 7 if cfg.mlp_gated else 6
    forward = per_layer * layers_ + 1
    assert counts["mm_fused"] == 2 * forward + decodes * (forward - 2 * cross)
    assert counts["flash_fwd"] == 2 * layers_ + decodes * cross
    assert counts["vpe_mm"] == 0
    over = []
    for i, (a, b) in enumerate(zip(card, cpu)):
        limit = tol if i < 2 else after
        assert (a.cpu() - b).abs().max().item() <= limit * b.abs().max().item(), i
        over.append((a.cpu() - b).abs().max().item() / b.abs().max().item() / moved)
    for (key, a), (_, b) in zip(tree_items(card_cache), tree_items(cpu_cache)):
        a = a.cpu()
        assert a.dtype == b.dtype, key
        if b.dtype == torch.float32:
            scale = max(b.abs().max().item(), 1e-30)
            assert (a - b).abs().max().item() <= tol * scale, key
        elif b.dtype == torch.bfloat16:
            torch.testing.assert_close(a.float(), b.float(), rtol=2.0**-7,
                                       atol=1e-5 * b.float().abs().max().item())
        else:
            assert torch.equal(a, b), key
    record_property("over_move", max(over[:2]))


# ---------------------------------------------------------------- the distribution layer


def test_sharded_step_world_of_one_is_the_unsharded_step(cuda):
    """One NCCL rank over a (1, 1) mesh: the sharded train step of reduced
    qwen3-0.6b (bf16 compute, ``arype_only``: every product on
    ``mm_fused``) is the unsharded step bit for bit: gradients, two steps'
    losses, the parameters and moments, and the launches."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import comm
    from repro_torch.optim import make_optimizer
    from repro_torch.train import steps

    cfg = reduced_config(get_config("qwen3-0.6b")).replace(
        compute_dtype="bfloat16", router_policy="arype_only", fsdp=True)
    opt = make_optimizer("adamw", 1e-2)
    comm.init_rank(0, 1, comm.free_port(), "cuda")
    try:
        assert dist.get_backend() == "nccl"
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        param_sh, opt_sh = steps.train_shardings(cfg, mesh, opt)
        params = LM(cfg, device=cuda).init(torch.Generator().manual_seed(0))
        local = steps.shard_tree(params, param_sh, mesh)
        opt_a, opt_b = opt.init(params), steps.shard_tree(opt.init(params), opt_sh, mesh)
        g = torch.Generator().manual_seed(1)
        batch = {k: torch.randint(0, cfg.vocab_size, (8, 32), generator=g).to(cuda)
                 for k in ("tokens", "labels")}
        kernels.reset_launches()
        want, wm = steps.grads_of(params, cfg, batch)
        want_counts = kernels.launches()
        kernels.reset_launches()
        got, gm = steps.sharded_grads_of(local, cfg, batch, mesh, param_sh)
        assert kernels.launches() == want_counts and want_counts["mm_fused"] > 0
        assert torch.equal(gm["loss"], wm["loss"])
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want)))
        plain = steps.make_train_step(cfg, opt)
        sharded = steps.make_sharded_train_step(cfg, opt, mesh, param_sh, opt_sh)
        for step in range(2):
            params, opt_a, ma = plain(params, opt_a, step, batch)
            local, opt_b, mb = sharded(local, opt_b, step, batch)
            assert torch.equal(ma["loss"], mb["loss"]) and torch.equal(ma["grad_norm"],
                                                                       mb["grad_norm"])
        for a, b in zip(tree_leaves((params, opt_a)), tree_leaves((local, opt_b))):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("cold", [0, 4096])
def test_shard_map_lanes_match_vmap_lanes_on_card(cuda, cold):
    """Four shard_map lanes, all on cuda:0, against the vmap lanes: every
    step's outputs and the state bit for bit, 4 ``flow_update`` a step
    against 1, the engines' launches as their recorded routes count."""
    from repro_torch.serving import ShardedOctopusPipeline

    mlp = init_paper_model("mlp", torch.Generator().manual_seed(0), device=cuda)
    cnn = init_paper_model("cnn", torch.Generator().manual_seed(1), device=cuda)
    cfg = PipelineConfig(table_size=1024, batch_size=256, max_ready=64, cold_size=cold)
    traffic = dict(batch_size=256, active_flows=1024 if cold else 512, table_size=1024, seed=3,
                   collision_free=not cold)
    gen = TrafficGenerator(TrafficConfig(**traffic), device="cpu")
    batches = [gen.next_batch() for _ in range(40)]
    vm = ShardedOctopusPipeline(mlp, cnn, cfg, num_shards=4, backend="vmap", device=cuda)
    sm = ShardedOctopusPipeline(mlp, cnn, cfg, num_shards=4, backend="shard_map",
                                devices=[cuda] * 4)
    for pipe, lanes in ((vm, 1), (sm, 4)):
        pipe.warmup()
        with record_routes() as routes:
            pipe.step(batches[0])
        pipe.reset()
        kernels.reset_launches()
        pipe.step(batches[1])
        want = kernels.matmul_launches(routes)
        want["flow_update"] += lanes
        assert kernels.launches() == want
        pipe.reset()
    for batch in batches:
        a, b = vm.step(batch), sm.step(batch)
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(vm.state),
                                                 tree_leaves(sm.state)))
    assert vm.rules.rules == sm.rules.rules and sm.stats.flows > 0
    if cold:
        assert sm.stats.spilled > 0
