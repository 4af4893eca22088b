"""The AryPE blocked-matmul engine: the plain PyTorch ``mm_fused`` /
``mm_fused_q`` / ``mm_unfused`` and the wrappers of the CUDA kernels
``csrc/mm_fused.cu`` / ``csrc/mm_fused_q.cu`` / ``csrc/mm_unfused_partials.cu``.

(M, K) @ (K, N) with the accumulator carried across K blocks and the
activation applied once, in the epilogue (the paper's fused collaborative
aggregation): in f32 (x and w each f32 or bf16, the output rounded once to
``out_dtype``; bf16 x on bf16 w past 8 rows on Hopper's bf16 tensor cores,
``csrc/mm_fused_wgmma.cu``), or on int8 codes with an int32 accumulator and a
per-channel dequant (the paper's fixed-point AryPE), from the same operand
and output types.  The unfused form is the paper's "wo/ collaborating"
ablation, f32 only: every K block's f32 partial product is written to memory
and the partials are summed in a second pass.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.common.util import ACTIVATIONS, BF16_ROADMAP, DTYPES, apply_activation, ceil_div
from repro_torch.kernels.build import H100_SMS, CudaKernel, check_cuda, sm_count, stream_of
from repro_torch.kernels.vpe_smallmm.ops import (
    check_matmul_shapes,
    check_quant_args,
    engine_out_dtype,
    scale_row,
)
from repro_torch.kernels.vpe_smallmm.ops import vpe_mm_q as mm_fused_q  # one exact int8 twin

# the reference kernels' K block (``_pick_blocks`` gives 128 whatever K), so an
# unfused matmul at its default block has a single partial on every paper shape
BLOCK_K = 128


def mm_fused(x: torch.Tensor, w: torch.Tensor, *, activation: str = "none",
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain twin of the kernel: one f32 accumulator summed over K blocks of
    the reference's depth on ``x.float()`` and ``w.float()``, the
    activation, then one rounding to ``out_dtype`` (x's dtype by default, as
    the reference's ``out_dtype or x.dtype``)."""
    m, k = x.shape
    acc = torch.zeros((m, w.shape[1]), dtype=torch.float32, device=x.device)
    for k0 in range(0, k, BLOCK_K):
        acc += x[:, k0:k0 + BLOCK_K].float() @ w[k0:k0 + BLOCK_K].float()
    return apply_activation(acc, activation).to(out_dtype or x.dtype)


# the tiles of csrc/mm_fused.cu, (variant, rows, columns) a CTA, in the order
# of the index its entry point takes: the skinny variant's column slabs over 8
# rows, then the tf32x3 variant's tiles, largest first (32 rows each, so a
# ragged M wastes at most 31), then the wgmma variant's (bf16 x bf16 on
# TMA-loadable operands: 64 rows a consumer warpgroup)
MM_FUSED_TILES = (("skinny", 8, 64), ("skinny", 8, 128),
                  ("tf32x3", 32, 128), ("tf32x3", 32, 64), ("tf32x3", 32, 32),
                  ("wgmma", 128, 128), ("wgmma", 128, 64), ("wgmma", 64, 128), ("wgmma", 64, 64))
TF32X3_TILES = tuple((bm, bn) for variant, bm, bn in MM_FUSED_TILES if variant == "tf32x3")
WGMMA_TILES = tuple((bm, bn) for variant, bm, bn in MM_FUSED_TILES if variant == "wgmma")
TMA_ALIGN = 16  # bytes of alignment TMA needs of the bases and the row strides
SKINNY_MAX_M = 8  # rows of the skinny variant's accumulators
MAX_CLUSTER = 8  # the portable cluster size, the skinny variant's most K ranks
# CTAs the skinny variant aims at: two 256-thread CTAs fit an SM, but a
# cluster must fit inside one GPC, so a grid near 2 x 132 CTAs in clusters of
# up to 8 may not be resident all at once; 192 leaves that room
SKINNY_CTAS = 192
# weight rows a skinny CTA reads in one unrolled step, by slab width: no K
# rank gets fewer
SKINNY_STEP_ROWS = {64: 128, 128: 64}
THIN_K = 4 * 32  # a CTA that walks at most four 32-deep K tiles takes the smallest tile
GRID_Y_MAX = 65535


class MmFusedPlan(NamedTuple):
    """How ``mm_fused`` runs one (M, K) @ (K, N): the variant, the output tile
    (``bm`` rows by ``bn`` columns a CTA) and ``split``, the K ranks of a
    cluster (1 where K is not split)."""
    variant: str
    bm: int
    bn: int
    split: int

    @property
    def tile(self) -> int:
        """The tile's index in :data:`MM_FUSED_TILES`, as the kernel takes it."""
        return MM_FUSED_TILES.index((self.variant, self.bm, self.bn))

    def grid(self, m: int, n: int) -> tuple[int, int]:
        """(x, y) of the launch grid: column tiles, then row tiles or K
        ranks; on the wgmma variant row tiles, then column tiles (M walks
        fastest, so the CTAs in flight share their weight columns in L2)."""
        if self.variant == "skinny":
            return ceil_div(n, self.bn), self.split
        if self.variant == "wgmma":
            return ceil_div(m, self.bm), ceil_div(n, self.bn)
        return ceil_div(n, self.bn), ceil_div(m, self.bm)


def mm_fused_plan(m: int, k: int, n: int, sms: int = H100_SMS,
                  x_dtype: torch.dtype = torch.float32, w_dtype: torch.dtype = torch.float32,
                  aligned: bool = True) -> MmFusedPlan:
    """The one place that picks how ``mm_fused`` runs a shape, from the shape,
    the operands' types and whether their bases are 16-byte aligned
    (``aligned``; the wrapper reads it from the tensors), and the card's
    ``sms`` (the wrapper reads it from the device).

    M <= 8 (:data:`SKINNY_MAX_M`) takes the skinny variant: cluster split-K,
    streaming the weights.  Its slab width and K ranks come from (K, N)
    only, so that slabs x ranks comes near :data:`SKINNY_CTAS` (at most
    :data:`MAX_CLUSTER` ranks, none shallower than one unrolled step; 128
    columns a slab only where the slabs alone reach it), and never from M:
    row r of an M = 4 call equals an M = 1 call on that row, bit for bit.

    bf16 x on bf16 w at M > 8 takes the wgmma variant where TMA can load
    both operands: bases 16-byte aligned and row strides (K and N bf16
    values) multiples of 16 bytes.  Its tile has 64 rows for M <= 64 and 128
    past that, and of :data:`WGMMA_TILES` with those rows the columns whose
    busiest SM computes the least output (the larger on a tie).  Its K order
    is the kernel's constant (64-deep tiles of four k16 steps), so rows do
    not depend on M or the tile.

    Every other M > 8 (f32 or mixed operands; bf16 x bf16 with odd K, N not
    a multiple of 8 or an unaligned base) takes the 3xTF32 tensor-core
    variant with a tile of :data:`TF32X3_TILES`: the one whose busiest SM
    computes the least output (the larger on a tie), or, for a K of at most
    :data:`THIN_K`, where a CTA's few K tiles leave it bound by latency, the
    smallest, for the most CTAs in flight.  K is never split there and its
    order does not depend on the tile, so rows do not depend on M either.

    Why 8: the LM decodes one row a slot (``batch_slots``, or 1 for a single
    request) and its head reads as many rows in both phases, while every
    prefill has 4 x S or S rows for prompts of S >= 16 tokens (``chip_smoke``
    draws 16-300, the reduced serve test 20 or more).  So decode and the head
    stay on the skinny variant and every prefill on a tensor-core one, and a
    served request decodes with the same bits as its single-request run."""
    if m <= SKINNY_MAX_M:
        bn = 128 if ceil_div(n, 128) >= SKINNY_CTAS else 64
        split = max(1, min(MAX_CLUSTER, SKINNY_CTAS // ceil_div(n, bn),
                           ceil_div(k, SKINNY_STEP_ROWS[bn])))
        return MmFusedPlan("skinny", SKINNY_MAX_M, bn, split)
    if x_dtype == w_dtype == torch.bfloat16 and aligned and k > 0 and (2 * k) % TMA_ALIGN == 0 \
            and (2 * n) % TMA_ALIGN == 0:
        bm = 64 if m <= 64 else 128
        tiles = [tile for tile in WGMMA_TILES if tile[0] == bm]
        return MmFusedPlan("wgmma", *min(tiles, key=lambda t: _busiest_sm(m, n, *t, sms)), 1)
    return MmFusedPlan("tf32x3", *gemm_tile(m, k, n, sms), 1)


def gemm_tile(m: int, depth: int, n: int, sms: int = H100_SMS, blocks: int = 1) -> tuple:
    """(rows, columns) of the 32-row tile (:data:`TF32X3_TILES`) that the
    tensor-core kernels of ``csrc/gemm_tiles.cuh`` (``mm_fused``'s tf32x3
    variant, ``mm_fused_q``, ``mm_unfused_partials``) run on an (M, N) output
    whose CTAs each walk ``depth`` of K, over ``blocks`` K blocks (the grid's
    z): the one whose busiest SM computes the least output (the larger on a
    tie), or, where a CTA walks at most :data:`THIN_K`, so that its few K
    tiles leave it bound by latency, the smallest, for the most CTAs in
    flight."""
    if depth <= THIN_K:
        return TF32X3_TILES[-1]
    return min(TF32X3_TILES, key=lambda tile: _busiest_sm(m, n, *tile, sms, blocks))


def _busiest_sm(m: int, n: int, bm: int, bn: int, sms: int, blocks: int = 1) -> int:
    """Output elements of the SM that gets the most CTAs of the grid."""
    return ceil_div(ceil_div(m, bm) * ceil_div(n, bn) * blocks, sms) * bm * bn


class TilePlan(NamedTuple):
    """How ``mm_fused_q`` or ``mm_unfused_partials`` runs one shape: the
    output tile (``bm`` rows by ``bn`` columns a CTA, one of
    :data:`TF32X3_TILES`) and ``blocks``, the K blocks of the grid's z (1
    where K is not split)."""
    bm: int
    bn: int
    blocks: int

    @property
    def tile(self) -> int:
        """The tile's index in :data:`TF32X3_TILES`, as the kernels take it."""
        return TF32X3_TILES.index((self.bm, self.bn))

    def grid(self, m: int, n: int) -> tuple[int, int, int]:
        """(x, y, z) of the launch grid: column tiles, row tiles, K blocks."""
        return ceil_div(n, self.bn), ceil_div(m, self.bm), self.blocks


def mm_fused_q_plan(m: int, k: int, n: int, sms: int = H100_SMS) -> TilePlan:
    """How ``mm_fused_q`` runs a shape, from the shape alone: the tile
    :func:`gemm_tile` picks for all of K, every M included (no int8 path has
    M <= 8, which the 32-row tile masks)."""
    return TilePlan(*gemm_tile(m, k, n, sms), 1)


def mm_unfused_plan(m: int, k: int, n: int, bk: int, sms: int = H100_SMS) -> TilePlan:
    """How ``mm_unfused_partials`` runs a shape in K blocks of ``bk``: one CTA
    per (column tile, row tile, block), each walking at most ``bk`` of K, the
    tile picked by :func:`gemm_tile` over all the blocks' CTAs."""
    blocks = ceil_div(k, bk)
    return TilePlan(*gemm_tile(m, min(bk, k), n, sms, blocks), blocks)


def operand_plan(x: torch.Tensor, w: torch.Tensor) -> MmFusedPlan:
    """The plan :func:`arype_matmul` launches for ``x @ w``: :func:`mm_fused_plan`
    of their shape, types and bases, for the card that holds them (an H100's
    SMs for CPU tensors, which run the plain twin)."""
    (m, k), n = x.shape, w.shape[1]
    aligned = x.data_ptr() % TMA_ALIGN == 0 and w.data_ptr() % TMA_ALIGN == 0
    sms = sm_count(x.device) if x.device.type == "cuda" else H100_SMS
    return mm_fused_plan(m, k, n, sms, x.dtype, w.dtype, aligned)


MM_FUSED = CudaKernel("mm_fused_launch", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                      + [ctypes.c_void_p])
# MM_FUSED's launches by the plan's variant (``kernels.reset_launches`` zeroes
# them with the counts)
VARIANT_LAUNCHES = dict.fromkeys(("skinny", "tf32x3", "wgmma"), 0)


def arype_matmul(x: torch.Tensor, w: torch.Tensor, *, activation: str = "none",
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N) on the AryPE engine: x and w each f32 or
    bf16, the sum and the activation in f32, the output ``out_dtype`` (x's
    by default).  On CPU tensors this is the plain :func:`mm_fused`; on CUDA
    tensors one launch of the kernel variant :func:`operand_plan` picks, on
    the tensors as they are (no cast around it), which masks ragged M/N/K
    edges itself (no padding), counted by variant in
    :data:`VARIANT_LAUNCHES`.  The skinny and tf32x3 variants give every pair
    of types the f32 arm's bits on ``x.float()``, ``w.float()``; the wgmma
    variant (bf16 x, bf16 w) sums K in another order, so it agrees with them
    within the bounds ``chip_smoke.py:hold_to_f64`` holds it to."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {tuple(ACTIVATIONS)}, got {activation!r}")
    out_dtype = engine_out_dtype("arype_matmul", x, w, out_dtype)
    if x.device.type == "cpu":
        return mm_fused(x, w, activation=activation, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"arype_matmul: no kernel for {x.device}")
    check_matmul_shapes("arype_matmul", x, w)
    (m, k), n = x.shape, w.shape[1]
    plan = operand_plan(x, w)
    if plan.grid(m, n)[1] > GRID_Y_MAX:
        raise ValueError(f"arype_matmul: (M, N) = ({m}, {n}) exceeds the kernel's grid")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m * n:
        MM_FUSED(x.device, x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n,
                 ACTIVATIONS[activation], plan.tile, plan.split, DTYPES[x.dtype],
                 DTYPES[w.dtype], DTYPES[out_dtype], stream_of(x))
        VARIANT_LAUNCHES[plan.variant] += 1
    return out


MM_FUSED_Q = CudaKernel("mm_fused_q_launch", [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float]
                        + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8 + [ctypes.c_void_p])


def arype_matmul_q(x: torch.Tensor, w: torch.Tensor, *, scale_x: float, scale_w,
                   activation: str = "none", out_dtype: Optional[torch.dtype] = None
                   ) -> torch.Tensor:
    """Int8 (M, K) @ (K, N) -> (M, N) on the AryPE engine: x and w (each f32
    or bf16) clip-rounded to int8 on the layer's scales (``scale_w`` a float
    or a per-output-channel tuple), fused int32 accumulation, dequant,
    activation, one rounding to ``out_dtype`` (x's by default, as the
    reference's ``out_dtype or x.dtype``).  On CPU tensors this is the plain
    :func:`mm_fused_q`; on CUDA tensors one launch of the kernel with the
    tile :func:`mm_fused_q_plan` picks, which quantizes each landed tile and
    masks ragged M/N/K (no padding)."""
    check_quant_args("arype_matmul_q", x, w, scale_w, activation)
    out_dtype = engine_out_dtype("arype_matmul_q", x, w, out_dtype)
    if x.device.type == "cpu":
        return mm_fused_q(x, w, scale_x=scale_x, scale_w=scale_w, activation=activation,
                          out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"arype_matmul_q: no kernel for {x.device}")
    check_matmul_shapes("arype_matmul_q", x, w)
    (m, k), n = x.shape, w.shape[1]
    plan = mm_fused_q_plan(m, k, n, sms=sm_count(x.device))
    if plan.grid(m, n)[1] > GRID_Y_MAX:
        raise ValueError(f"arype_matmul_q: M={m} exceeds the kernel's grid")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m * n:
        MM_FUSED_Q(x.device, x.data_ptr(), w.data_ptr(), scale_x,
                   scale_row(scale_w, n, x.device).data_ptr(), out.data_ptr(), m, k, n,
                   ACTIVATIONS[activation], plan.tile, DTYPES[x.dtype], DTYPES[w.dtype],
                   DTYPES[out_dtype], stream_of(x))
    return out


# ------------------------------------------------------------------ unfused


def mm_unfused_partials_plain(x: torch.Tensor, w: torch.Tensor, *, bk: int) -> torch.Tensor:
    """Plain twin of the partials kernel: ``P[l] = x[:, l*bk:(l+1)*bk] @
    w[l*bk:(l+1)*bk]`` stacked as (ceil(K/bk), M, N) f32."""
    k = x.shape[1]
    return torch.stack([x[:, k0:k0 + bk].float() @ w[k0:k0 + bk].float()
                        for k0 in range(0, k, bk)])


def sum_partials(partials: torch.Tensor, activation: str) -> torch.Tensor:
    """Plain twin of the aggregation kernel: the partials summed one after
    another in block order, then the activation."""
    out = partials[0]
    for p in partials[1:]:
        out = out + p
    return apply_activation(out, activation)


def mm_unfused(x: torch.Tensor, w: torch.Tensor, *, activation: str = "none",
               bk: int) -> torch.Tensor:
    """Plain twin of :func:`arype_matmul_unfused`: partials, then their sum."""
    return sum_partials(mm_unfused_partials_plain(x, w, bk=bk), activation)


MM_UNFUSED_PARTIALS = CudaKernel("mm_unfused_partials_launch",
                                 [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
MM_PARTIALS_SUM = CudaKernel("mm_partials_sum_launch",
                             [ctypes.c_void_p] * 2 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                                      ctypes.c_void_p])


def _check_unfused(name: str, x: torch.Tensor, w: torch.Tensor, bk: int) -> None:
    """What the unfused matmul takes, on any device: f32 operands (only the
    f32 CNN runs it; its other types are :data:`BF16_ROADMAP`), and on the
    card those of :func:`check_matmul_shapes` within the kernels' grids."""
    if bk <= 0:
        raise ValueError(f"{name}: bk must be positive, got {bk}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0] or x.shape[1] == 0:
        raise ValueError(f"{name}: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError(f"{name}: needs float32, got {x.dtype} @ {w.dtype} (other "
                         f"types of this engine are not ported: {BF16_ROADMAP})")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for {x.device}")
    if x.device.type == "cuda":
        check_matmul_shapes(name, x, w)
        m, k = x.shape
        if ceil_div(m, TF32X3_TILES[0][0]) > GRID_Y_MAX or ceil_div(k, bk) > 65535:
            raise ValueError(f"{name}: M={m} or K/bk={ceil_div(k, bk)} exceeds the kernel's grid")
        if ceil_div(k, bk) * m * w.shape[1] >= 2**31:
            raise ValueError(f"{name}: partials too large for the kernel's int sizes")


def _launch_partials(x: torch.Tensor, w: torch.Tensor, bk: int) -> torch.Tensor:
    (m, k), n = x.shape, w.shape[1]
    partials = torch.empty((ceil_div(k, bk), m, n), dtype=torch.float32, device=x.device)
    if m * n:
        MM_UNFUSED_PARTIALS(x.device, x.data_ptr(), w.data_ptr(), partials.data_ptr(),
                            m, k, n, bk, mm_unfused_plan(m, k, n, bk, sm_count(x.device)).tile,
                            stream_of(x))
    return partials


def mm_unfused_partials(x: torch.Tensor, w: torch.Tensor, *, bk: int = BLOCK_K) -> torch.Tensor:
    """(M, K) @ (K, N) -> the (ceil(K/bk), M, N) f32 K-block partials.  On CPU
    tensors this is the plain :func:`mm_unfused_partials_plain`; on CUDA
    tensors one launch of the partials kernel with the tile
    :func:`mm_unfused_plan` picks, which masks ragged edges."""
    _check_unfused("mm_unfused_partials", x, w, bk)
    if x.device.type == "cpu":
        return mm_unfused_partials_plain(x, w, bk=bk)
    return _launch_partials(x, w, bk)


def arype_matmul_unfused(x: torch.Tensor, w: torch.Tensor, *, activation: str = "none",
                         bk: Optional[int] = None) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N) f32 without fused aggregation: the K-block
    partials go to memory and a second pass sums them in block order and
    applies the activation.  ``bk=None`` takes the reference wrapper's block,
    :data:`BLOCK_K`.  On CPU tensors this is the plain
    :func:`mm_unfused`; on CUDA tensors two launches, partials then sum.  On
    ``meta`` tensors (a :class:`~repro_torch.runtime.plan.RoutePlan` trace)
    an empty ``meta`` result: nothing runs."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {tuple(ACTIVATIONS)}, got {activation!r}")
    if x.device.type == "meta":
        return torch.empty((x.shape[0], w.shape[1]), dtype=torch.float32, device="meta")
    bk = BLOCK_K if bk is None else bk
    _check_unfused("arype_matmul_unfused", x, w, bk)
    if x.device.type == "cpu":
        return mm_unfused(x, w, activation=activation, bk=bk)
    return partials_sum(_launch_partials(x, w, bk), activation=activation)


def partials_sum(partials: torch.Tensor, *, activation: str = "none") -> torch.Tensor:
    """The unfused matmul's second pass: (L, M, N) f32 partials summed in
    block order, then the activation.  On CPU tensors this is the plain
    :func:`sum_partials`; on CUDA tensors one launch of the sum kernel."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {tuple(ACTIVATIONS)}, got {activation!r}")
    if partials.dim() != 3 or partials.dtype != torch.float32 or partials.shape[0] == 0:
        raise ValueError(f"partials_sum: needs (L>0, M, N) float32, got "
                         f"{tuple(partials.shape)} {partials.dtype}")
    if partials.device.type == "cpu":
        return sum_partials(partials, activation)
    if partials.device.type != "cuda":
        raise ValueError(f"partials_sum: no kernel for {partials.device}")
    check_cuda("partials_sum", partials)
    out = torch.empty(partials.shape[1:], dtype=torch.float32, device=partials.device)
    if out.numel():
        MM_PARTIALS_SUM(partials.device, partials.data_ptr(), out.data_ptr(), out.numel(),
                        partials.shape[0], ACTIVATIONS[activation], stream_of(partials))
    return out
