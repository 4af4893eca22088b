"""The AryPE blocked-matmul engine: the plain PyTorch ``mm_fused`` and the
wrapper of the CUDA kernel ``csrc/mm_fused.cu``.

(M, K) @ (K, N) with the f32 accumulator carried across K blocks and the
activation applied once, in the epilogue (the paper's fused collaborative
aggregation).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.common.util import ACTIVATIONS, apply_activation
from repro_torch.kernels.build import CudaKernel, stream_of
from repro_torch.kernels.vpe_smallmm.ops import check_matmul_operands

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
