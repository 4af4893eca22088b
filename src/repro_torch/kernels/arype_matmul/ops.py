"""The AryPE blocked-matmul engine: the plain PyTorch ``mm_fused`` /
``mm_fused_q`` / ``mm_unfused`` and the wrappers of the CUDA kernels
``csrc/mm_fused.cu`` / ``csrc/mm_fused_q.cu`` / ``csrc/mm_unfused_partials.cu``.

(M, K) @ (K, N) with the accumulator carried across K blocks and the
activation applied once, in the epilogue (the paper's fused collaborative
aggregation): in f32, or on int8 codes with an int32 accumulator and a
per-channel dequant (the paper's fixed-point AryPE).  The unfused form is the
paper's "wo/ collaborating" ablation: every K block's f32 partial product is
written to memory and the partials are summed in a second pass.
"""
from __future__ import annotations

import ctypes

import torch

from typing import Optional

from repro_torch.common.util import ACTIVATIONS, apply_activation, ceil_div
from repro_torch.kernels.build import CudaKernel, stream_of
from repro_torch.kernels.vpe_smallmm.ops import check_matmul_operands, check_quant_args, scale_row
from repro_torch.kernels.vpe_smallmm.ops import vpe_mm_q as mm_fused_q  # one exact int8 twin

# the reference kernels' K block (``_pick_blocks`` gives 128 whatever K), so an
# unfused matmul at its default block has a single partial on every paper shape
BLOCK_K = 128


def mm_fused(x: torch.Tensor, w: torch.Tensor, *, activation: str = "none") -> torch.Tensor:
    """Plain twin of the kernel: one f32 accumulator summed over K blocks of
    the reference's depth, then the activation."""
    m, k = x.shape
    acc = torch.zeros((m, w.shape[1]), dtype=torch.float32, device=x.device)
    for k0 in range(0, k, BLOCK_K):
        acc += x[:, k0:k0 + BLOCK_K].float() @ w[k0:k0 + BLOCK_K].float()
    return apply_activation(acc, activation)


MM_FUSED = CudaKernel("mm_fused_launch", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                      + [ctypes.c_void_p])


def arype_matmul(x: torch.Tensor, w: torch.Tensor, *, activation: str = "none") -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N) f32 on the AryPE engine.  On CPU tensors this
    is the plain :func:`mm_fused`; on CUDA tensors it launches the kernel,
    which masks ragged M/N/K edges itself (no padding)."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {tuple(ACTIVATIONS)}, got {activation!r}")
    if x.device.type == "cpu":
        return mm_fused(x, w, activation=activation)
    if x.device.type != "cuda":
        raise ValueError(f"arype_matmul: no kernel for {x.device}")
    check_matmul_operands("arype_matmul", x, w)
    (m, k), n = x.shape, w.shape[1]
    if m >= 64 * 65535:
        raise ValueError(f"arype_matmul: M={m} exceeds the kernel's grid")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m * n:
        MM_FUSED(x.device, x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n,
                 ACTIVATIONS[activation], stream_of(x))
    return out


MM_FUSED_Q = CudaKernel("mm_fused_q_launch", [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float]
                        + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def arype_matmul_q(x: torch.Tensor, w: torch.Tensor, *, scale_x: float, scale_w,
                   activation: str = "none") -> torch.Tensor:
    """Int8 (M, K) @ (K, N) -> (M, N) f32 on the AryPE engine: f32 operands
    clip-rounded to int8 on the layer's scales (``scale_w`` a float or a
    per-output-channel tuple), fused int32 accumulation, dequant, activation.
    On CPU tensors this is the plain :func:`mm_fused_q`; on CUDA tensors one
    launch of the kernel, which quantizes on load and masks ragged M/N/K."""
    check_quant_args("arype_matmul_q", x, w, scale_w, activation)
    if x.device.type == "cpu":
        return mm_fused_q(x, w, scale_x=scale_x, scale_w=scale_w, activation=activation)
    if x.device.type != "cuda":
        raise ValueError(f"arype_matmul_q: no kernel for {x.device}")
    check_matmul_operands("arype_matmul_q", x, w)
    (m, k), n = x.shape, w.shape[1]
    if m >= 64 * 65535:
        raise ValueError(f"arype_matmul_q: M={m} exceeds the kernel's grid")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m * n:
        MM_FUSED_Q(x.device, x.data_ptr(), w.data_ptr(), scale_x,
                   scale_row(scale_w, n, x.device).data_ptr(), out.data_ptr(), m, k, n,
                   ACTIVATIONS[activation], stream_of(x))
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
                                 [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
MM_PARTIALS_SUM = CudaKernel("mm_partials_sum_launch",
                             [ctypes.c_void_p] * 2 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                                      ctypes.c_void_p])


def _check_unfused(name: str, x: torch.Tensor, w: torch.Tensor, bk: int) -> None:
    if bk <= 0:
        raise ValueError(f"{name}: bk must be positive, got {bk}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0] or x.shape[1] == 0:
        raise ValueError(f"{name}: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for {x.device}")
    if x.device.type == "cuda":
        check_matmul_operands(name, x, w)
        m, k = x.shape
        if m >= 64 * 65535 or ceil_div(k, bk) > 65535:
            raise ValueError(f"{name}: M={m} or K/bk={ceil_div(k, bk)} exceeds the kernel's grid")
        if ceil_div(k, bk) * m * w.shape[1] >= 2**31:
            raise ValueError(f"{name}: partials too large for the kernel's int sizes")


def _launch_partials(x: torch.Tensor, w: torch.Tensor, bk: int) -> torch.Tensor:
    (m, k), n = x.shape, w.shape[1]
    partials = torch.empty((ceil_div(k, bk), m, n), dtype=torch.float32, device=x.device)
    if m * n:
        MM_UNFUSED_PARTIALS(x.device, x.data_ptr(), w.data_ptr(), partials.data_ptr(),
                            m, k, n, bk, stream_of(x))
    return partials


def mm_unfused_partials(x: torch.Tensor, w: torch.Tensor, *, bk: int = BLOCK_K) -> torch.Tensor:
    """(M, K) @ (K, N) -> the (ceil(K/bk), M, N) f32 K-block partials.  On CPU
    tensors this is the plain :func:`mm_unfused_partials_plain`; on CUDA
    tensors one launch of the partials kernel, which masks ragged edges."""
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
    partials = _launch_partials(x, w, bk)
    out = torch.empty(partials.shape[1:], dtype=torch.float32, device=x.device)
    if out.numel():
        MM_PARTIALS_SUM(x.device, partials.data_ptr(), out.data_ptr(), out.numel(),
                        partials.shape[0], ACTIVATIONS[activation], stream_of(x))
    return out
