"""The VPE small-matmul engine: the plain PyTorch ``vpe_mm`` and the wrapper
of the CUDA kernel ``csrc/vpe_mm.cu``.

Small or skinny (M, K) @ (K, N) products (K*N small) as an f32
broadcast-multiply and a reduce over K, with a fused activation.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.common.util import ACTIVATIONS, apply_activation
from repro_torch.kernels.build import CudaKernel, check_cuda, stream_of


def vpe_mm(x: torch.Tensor, w: torch.Tensor, *, activation: str = "none") -> torch.Tensor:
    """Plain twin of the kernel: broadcast-multiply, then sum over K."""
    out = (x[:, :, None].float() * w[None, :, :].float()).sum(dim=1)
    return apply_activation(out, activation)


VPE_MM = CudaKernel("vpe_mm_launch", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                    + [ctypes.c_void_p])


def check_matmul_operands(name: str, x: torch.Tensor, w: torch.Tensor) -> None:
    """What both engine kernels take: 2-D contiguous f32 on one CUDA device,
    with sizes that fit their int arguments."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{name}: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError(f"{name}: needs float32, got {x.dtype} @ {w.dtype}")
    if max(x.numel(), w.numel()) >= 2**31:
        raise ValueError(f"{name}: operands too large for the kernel's int sizes")
    check_cuda(name, x, w)


def vpe_matmul(x: torch.Tensor, w: torch.Tensor, *, activation: str = "none") -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N) f32 on the VPE engine.  On CPU tensors this is
    the plain :func:`vpe_mm`; on CUDA tensors it launches the kernel, which
    masks the ragged M edge itself (no padding)."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {tuple(ACTIVATIONS)}, got {activation!r}")
    if x.device.type == "cpu":
        return vpe_mm(x, w, activation=activation)
    if x.device.type != "cuda":
        raise ValueError(f"vpe_matmul: no kernel for {x.device}")
    check_matmul_operands("vpe_matmul", x, w)
    (m, k), n = x.shape, w.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m * n:
        VPE_MM(x.device, x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n,
               ACTIVATIONS[activation], stream_of(x))
    return out
