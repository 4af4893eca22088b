"""The AryPE blocked-matmul engine: the plain PyTorch ``mm_fused`` /
``mm_fused_q`` and the wrappers of the CUDA kernels ``csrc/mm_fused.cu`` /
``csrc/mm_fused_q.cu``.

(M, K) @ (K, N) with the accumulator carried across K blocks and the
activation applied once, in the epilogue (the paper's fused collaborative
aggregation): in f32, or on int8 codes with an int32 accumulator and a
per-channel dequant (the paper's fixed-point AryPE).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.common.util import ACTIVATIONS, apply_activation
from repro_torch.kernels.build import CudaKernel, stream_of
from repro_torch.kernels.vpe_smallmm.ops import check_matmul_operands, check_quant_args, scale_row
from repro_torch.kernels.vpe_smallmm.ops import vpe_mm_q as mm_fused_q  # one exact int8 twin

BLOCK_K = 128  # the reference kernel's K block


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
