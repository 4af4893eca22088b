"""The VPE small-matmul engine: the plain PyTorch ``vpe_mm`` / ``vpe_mm_q``
and the wrappers of the CUDA kernels ``csrc/vpe_mm.cu`` / ``csrc/vpe_mm_q.cu``.

Small or skinny (M, K) @ (K, N) products (K*N small) as a broadcast-multiply
and a reduce over K, with a fused activation: in f32 (x and w each f32 or
bf16, the output rounded once to ``out_dtype``), or on int8 codes with an
int32 sum and a per-channel dequant (the paper's fixed-point SIMDU), from the
same operand and output types.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.common.util import ACTIVATIONS, DTYPES, apply_activation, ceil_div
from repro_torch.kernels.build import CudaKernel, check_cuda, stream_of
from repro_torch.runtime.quant import I32_MAX_K, dequant_row, quantize_i8


def vpe_mm(x: torch.Tensor, w: torch.Tensor, *, activation: str = "none",
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain twin of the kernel: broadcast-multiply in f32, sum over K, the
    activation, then one rounding to ``out_dtype`` (x's dtype by default)."""
    out = (x[:, :, None].float() * w[None, :, :].float()).sum(dim=1)
    return apply_activation(out, activation).to(out_dtype or x.dtype)


VPE_MM = CudaKernel("vpe_mm_launch", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                    + [ctypes.c_void_p])


class VpePlan(NamedTuple):
    """How ``vpe_mm`` runs one (M, K) @ (K, N): ``variant`` "skinny" (the
    cluster split-K of ``csrc/skinny.cuh``, in slabs of ``bn`` columns over
    ``split`` K ranks) or "thread" (one thread an output; ``bn`` 0, ``split``
    1), passed to the kernel as (bn, split)."""
    variant: str
    bn: int
    split: int


def vpe_plan(m: int, k: int, n: int) -> VpePlan:
    """The one place that picks how ``vpe_mm`` runs a shape, from the shape
    alone.

    M <= 8 takes the skinny split-K with the slab and K ranks that
    ``arype_matmul.ops.mm_fused_plan`` gives (K, N), so the VPE and the AryPE
    run the same code in the same K order there: the same bits at every M
    <= 8, and rows that do not depend on M.  Why 8: those are the skinny
    kernel's accumulator rows, and the VPE's rows that low come from one-row
    projections: a batch-1 LM decode gives M 1 (qwen3-0.6b's wq/wk/wv/wo at
    K 1024-2048, N 1024-2048, where one thread an output would run a K-deep
    FMA chain on 4-8 CTAs), and the reduced serve tests' collaborative
    placements 1-2 slots.  Every M > 8 (the pipelines' MLP and conv1, M
    1024-5120 at K 3-12) keeps one thread an output, where the launch
    dominates and a K of 3-12 leaves nothing to split."""
    from repro_torch.kernels.arype_matmul.ops import SKINNY_MAX_M, mm_fused_plan

    if m <= SKINNY_MAX_M:
        plan = mm_fused_plan(m, k, n)
        return VpePlan("skinny", plan.bn, plan.split)
    return VpePlan("thread", 0, 1)


def check_matmul_shapes(name: str, x: torch.Tensor, w: torch.Tensor) -> None:
    """What every engine kernel takes: 2-D contiguous operands on one CUDA
    device, with sizes that fit their int arguments."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{name}: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if max(x.numel(), w.numel()) >= 2**31:
        raise ValueError(f"{name}: operands too large for the kernel's int sizes")
    check_cuda(name, x, w)


def engine_out_dtype(name: str, x: torch.Tensor, w: torch.Tensor,
                     out_dtype: Optional[torch.dtype]) -> torch.dtype:
    """The output type of an engine matmul, x's by default (the reference's
    ``out_dtype or x.dtype``), refusing on any device what the kernels do not
    build: x, w and the output each f32 or bf16 (all eight pairs of types)."""
    out_dtype = out_dtype or x.dtype
    if x.dtype not in DTYPES or w.dtype not in DTYPES or out_dtype not in DTYPES:
        raise ValueError(f"{name}: runs x, w and the output each float32 or bfloat16; got "
                         f"{x.dtype} @ {w.dtype} -> {out_dtype}")
    return out_dtype


def vpe_matmul(x: torch.Tensor, w: torch.Tensor, *, activation: str = "none",
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N) on the VPE engine: x and w each f32 or bf16,
    the sum and the activation in f32, the output ``out_dtype`` (x's by
    default).  On CPU tensors this is the plain :func:`vpe_mm`; on CUDA
    tensors it launches the kernel :func:`vpe_plan` picks on the tensors as
    they are (no cast around it), which masks the ragged edges itself (no
    padding)."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {tuple(ACTIVATIONS)}, got {activation!r}")
    out_dtype = engine_out_dtype("vpe_matmul", x, w, out_dtype)
    if x.device.type == "cpu":
        return vpe_mm(x, w, activation=activation, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"vpe_matmul: no kernel for {x.device}")
    check_matmul_shapes("vpe_matmul", x, w)
    (m, k), n = x.shape, w.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m * n:
        plan = vpe_plan(m, k, n)
        VPE_MM(x.device, x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n,
               ACTIVATIONS[activation], plan.bn, plan.split, DTYPES[x.dtype],
               DTYPES[w.dtype], DTYPES[out_dtype], stream_of(x))
    return out


# ------------------------------------------------------------------ int8


Q_BLOCK_K = 128  # K block of the plain int8 twin, bounding its (M, K, N) product


def vpe_mm_q(x: torch.Tensor, w: torch.Tensor, *, scale_x: float, scale_w,
             activation: str = "none", out_dtype: Optional[torch.dtype] = None
             ) -> torch.Tensor:
    """Plain twin of both int8 kernels (``vpe_mm_q`` and ``mm_fused_q``):
    both operands to int8 codes (a bf16 element divided as its exact f32),
    an exact int32 broadcast-multiply-sum over K blocks (torch has no integer
    matmul on the card; an integer sum is the same in any order, so one twin
    serves both engines), the dequant row, the activation, then one rounding
    to ``out_dtype`` (x's dtype by default)."""
    (m, k), n = x.shape, w.shape[1]
    xq = quantize_i8(x, scale_x).to(torch.int32)
    wq = quantize_i8(w, scale_w).to(torch.int32)
    acc = torch.zeros((m, n), dtype=torch.int32, device=x.device)
    for k0 in range(0, k, Q_BLOCK_K):
        blk = slice(k0, k0 + Q_BLOCK_K)
        acc += (xq[:, blk, None] * wq[None, blk, :]).sum(dim=1, dtype=torch.int32)
    dq = torch.from_numpy(dequant_row(scale_x, scale_w, n)).to(x.device)
    return apply_activation(acc.float() * dq, activation).to(out_dtype or x.dtype)


VPE_MM_Q = CudaKernel("vpe_mm_q_launch", [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float]
                      + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
Q_THREADS, Q_OUTPUTS = 256, 8  # csrc/vpe_mm_q.cu: threads a CTA, outputs a thread at most
Q_ROWS = 16  # rows a CTA (see vpe_q_plan)
Q_MAX_BN = 256  # columns a CTA at most: up to it, every x element is quantized once
Q_MAX_CODES = 48 * 1024  # one-byte codes a CTA stages, x's and w's


class VpeQPlan(NamedTuple):
    """How ``vpe_mm_q`` runs one (M, K) @ (K, N): a CTA owns a ``bm`` x ``bn``
    output tile and stages ``bk`` of K a step, as int8 codes."""
    bm: int
    bn: int
    bk: int

    def grid(self, m: int, n: int) -> tuple:
        return ceil_div(m, self.bm), ceil_div(n, self.bn)


def vpe_q_plan(m: int, k: int, n: int) -> VpeQPlan:
    """The one place that sizes ``vpe_mm_q``'s tile, from the shape alone.
    All N up to :data:`Q_MAX_BN` columns in one tile, so x is quantized once;
    :data:`Q_ROWS` rows (fewer where the CTA's threads cannot hold that many
    outputs); then as much of K as the shared codes take.

    Why 16 rows: at the pipelines' shapes (K 3-12, N 2-32) a call's time is
    the launch and one round trip of reads, and each CTA adds to it.  On an
    H100, 16 rows a CTA was among the fastest at each of the five shapes
    (``chip_smoke.py --kernel-times`` sweeps 2 to 256 rows; PERF.md §6):
    fewer rows take more CTAs (8 rows, one CTA an SM at M 1024, and 39 at
    conv1's M 5120 measured up to 0.3 us slower), more rows more outputs a
    thread or more codes a CTA."""
    bn = min(n, Q_MAX_BN)
    bm = max(1, min(Q_ROWS, Q_THREADS * Q_OUTPUTS // bn, m))
    return VpeQPlan(bm, bn, max(1, min(k, Q_MAX_CODES // (bm + bn))))


def check_quant_args(name: str, x: torch.Tensor, w: torch.Tensor, scale_w,
                     activation: str) -> None:
    """What both int8 engines take, on any device: a known activation, a
    weight scale per tensor or one per output channel, and a depth whose
    int32 sum cannot overflow."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {tuple(ACTIVATIONS)}, got {activation!r}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{name}: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if isinstance(scale_w, tuple) and len(scale_w) != w.shape[1]:
        raise ValueError(f"{name}: {len(scale_w)} channel scales for N={w.shape[1]}")
    if w.shape[0] > I32_MAX_K:
        raise ValueError(f"{name}: K={w.shape[0]} overflows the int32 sum "
                         f"(K * 127^2 must stay below 2^31)")


@functools.lru_cache(maxsize=256)
def scale_row(scale_w, n: int, device: torch.device) -> torch.Tensor:
    """The (N,) f32 weight-scale row the int8 kernels read, made once per
    table entry and device so a step copies nothing to the card."""
    row = np.broadcast_to(np.asarray(scale_w, np.float32), (n,)).copy()
    return torch.from_numpy(row).to(device)


def vpe_matmul_q(x: torch.Tensor, w: torch.Tensor, *, scale_x: float, scale_w,
                 activation: str = "none", out_dtype: Optional[torch.dtype] = None
                 ) -> torch.Tensor:
    """Int8 (M, K) @ (K, N) -> (M, N) on the VPE engine: x and w (each f32
    or bf16) clip-rounded to int8 on the layer's scales (``scale_w`` a float
    or a per-output-channel tuple), int32 sum, dequant, activation, one
    rounding to ``out_dtype`` (x's by default, as the reference's
    ``out_dtype or x.dtype``).  On CPU tensors this is the plain
    :func:`vpe_mm_q`; on CUDA tensors one launch of the kernel in the tile
    :func:`vpe_q_plan` picks, which quantizes on load and masks the ragged
    edges."""
    check_quant_args("vpe_matmul_q", x, w, scale_w, activation)
    out_dtype = engine_out_dtype("vpe_matmul_q", x, w, out_dtype)
    if x.device.type == "cpu":
        return vpe_mm_q(x, w, scale_x=scale_x, scale_w=scale_w, activation=activation,
                        out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"vpe_matmul_q: no kernel for {x.device}")
    check_matmul_shapes("vpe_matmul_q", x, w)
    (m, k), n = x.shape, w.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m * n:
        plan = vpe_q_plan(m, k, n)
        VPE_MM_Q(x.device, x.data_ptr(), w.data_ptr(), scale_x,
                 scale_row(scale_w, n, x.device).data_ptr(), out.data_ptr(), m, k, n,
                 ACTIVATIONS[activation], *plan, DTYPES[x.dtype], DTYPES[w.dtype],
                 DTYPES[out_dtype], stream_of(x))
    return out
