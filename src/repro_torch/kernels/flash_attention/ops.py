"""Flash attention forward: the plain PyTorch ``flash_fwd``, the oracle
``ref_attention`` and the wrapper ``flash_attention`` of the CUDA kernel
``csrc/flash_fwd.cu``.

An online softmax over KV blocks (running max ``m``, normalizer ``l`` and
accumulator ``acc`` rescaled by ``alpha`` as each block arrives), so the
(Sq, Sk) score matrix never exists whole; KV blocks that the mask rules out
are skipped.  Masks: "causal", "local" (sliding window, causal) and "full"
(bidirectional), with keys at or past ``kv_len`` masked.  A fully masked row
gives zeros, not NaN.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import CudaKernel, stream_of

NEG_INF = -1e30  # the reference's mask value, not -inf
MASKS = {"full": 0, "causal": 1, "local": 2}  # codes of csrc/flash_fwd.cu
MAX_HEAD_DIM = 256


def valid_pairs(mask: str, window: int, kv_len: int, qpos: torch.Tensor,
                kpos: torch.Tensor) -> torch.Tensor:
    """Which (query position, key position) pairs the mask lets attend, as
    the broadcast of ``qpos`` (Sq, 1) against ``kpos`` (1, Sk)."""
    valid = (kpos < kv_len) & (qpos >= 0)
    if mask == "causal":
        valid = valid & (qpos >= kpos)
    elif mask == "local":
        valid = valid & (qpos >= kpos) & (qpos - kpos < window)
    return valid


def _relevant(mask: str, window: int, q_start: int, bq: int, k_start: int, bk: int) -> bool:
    """Whether a (bq, bk) block can hold a valid key (the reference body's
    ``relevant``); a block ruled out is fully masked, so skipping it changes
    nothing."""
    if mask == "causal":
        return k_start <= q_start + bq - 1
    if mask == "local":
        return k_start <= q_start + bq - 1 and k_start + bk - 1 >= q_start - window + 1
    return True


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, mask: str = "causal",
              window: int = 0, kv_len: Optional[int] = None, bq: int = 128, bk: int = 128,
              scale: Optional[float] = None) -> torch.Tensor:
    """Plain twin of the kernel on (BH, Sq, D) / (BH, Sk, D): the reference
    body's online softmax over (bq, bk) blocks in its order of operations
    (q scaled before the dot, ``NEG_INF`` for masked scores, masked p set to
    0, ``alpha`` rescaling, ``l == 0 -> 1``, the output cast to the input
    type).  Ragged Sq and Sk end in a shorter block; masked keys add exact
    zeros, so that equals the reference's padded blocks."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    kv_len = sk if kv_len is None else kv_len
    out = torch.empty_like(q)
    for q0 in range(0, sq, bq):
        qb = q[:, q0:q0 + bq].float() * scale
        nq = qb.shape[1]
        qpos = torch.arange(q0, q0 + nq, device=q.device)[:, None]
        m = torch.full((bh, nq, 1), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((bh, nq, 1), dtype=torch.float32, device=q.device)
        acc = torch.zeros((bh, nq, d), dtype=torch.float32, device=q.device)
        for k0 in range(0, sk, bk):
            if not _relevant(mask, window, q0, bq, k0, bk):
                continue
            kb, vb = k[:, k0:k0 + bk].float(), v[:, k0:k0 + bk].float()
            kpos = torch.arange(k0, k0 + kb.shape[1], device=q.device)[None, :]
            valid = valid_pairs(mask, window, kv_len, qpos, kpos)
            s = torch.where(valid, qb @ kb.transpose(1, 2), NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.where(valid, torch.exp(s - m_new), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p @ vb
            m = m_new
        l = torch.where(l == 0.0, 1.0, l)
        out[:, q0:q0 + nq] = (acc / l).to(q.dtype)
    return out


def ref_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, mask: str = "causal",
                  window: int = 0, kv_len: Optional[int] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """The oracle (the reference's ``ref.py:ref_attention``): the whole
    score matrix at once, for test shapes only."""
    sq, d = q.shape[1], q.shape[2]
    sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    kv_len = sk if kv_len is None else kv_len
    s = (q.float() * scale) @ k.float().transpose(1, 2)
    valid = valid_pairs(mask, window, kv_len, torch.arange(sq, device=q.device)[:, None],
                   torch.arange(sk, device=q.device)[None, :])
    s = torch.where(valid, s, NEG_INF)
    p = torch.where(valid, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    return ((p / torch.where(l == 0.0, 1.0, l)) @ v.float()).to(q.dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          mask: str = "causal", window: int = 0, kv_len: Optional[int] = None,
                          bq: int = 128, bk: int = 128) -> torch.Tensor:
    """Plain twin of :func:`flash_attention` on (B, H, S, D), as the
    reference wrapper runs its kernel: KV heads repeated for GQA, heads folded
    into the batch, :func:`flash_fwd` on blocks ``min(bq, Sq)`` x
    ``min(bk, Sk)``."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if hq > hkv:
        k, v = k.repeat_interleave(hq // hkv, dim=1), v.repeat_interleave(hq // hkv, dim=1)
    out = flash_fwd(q.reshape(b * hq, sq, d), k.reshape(b * hq, sk, d), v.reshape(b * hq, sk, d),
                    mask=mask, window=window, kv_len=kv_len, bq=max(min(bq, sq), 1),
                    bk=max(min(bk, sk), 1))
    return out.reshape(b, hq, sq, d)


FLASH_FWD = CudaKernel("flash_fwd_launch", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_int64] * 12 + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_void_p])


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: str, window: int,
           kv_len: int) -> None:
    if mask not in MASKS:
        raise ValueError(f"mask must be one of {tuple(MASKS)}, got {mask!r}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: want (B, Hq, Sq, D) and (B, Hkv, Sk, D)")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[1] == 0 or hq % k.shape[1]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} against k {tuple(k.shape)}")
    if not 0 <= kv_len <= k.shape[2]:
        raise ValueError(f"flash_attention: kv_len {kv_len} outside [0, Sk={k.shape[2]}]")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    mask: str = "causal", window: int = 0,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """Attention of q (B, Hq, Sq, D) over k, v (B, Hkv, Sk, D), Hq a multiple
    of Hkv (GQA), -> (B, Hq, Sq, D) in q's type.

    On CPU tensors this is the plain :func:`flash_attention_plain` at the
    reference wrapper's default 128 x 128 blocks.  On CUDA tensors one launch
    of the kernel at its own 64 x 32 tiles: f32 or bf16, D a multiple of 8 up
    to 256, any strides with D contiguous, GQA and ragged Sq/Sk handled in
    place, so nothing is copied or padded."""
    kv_len = k.shape[2] if kv_len is None else kv_len
    _check(q, k, v, mask, window, kv_len)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask=mask, window=window, kv_len=kv_len)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: needs float32 or bfloat16 throughout, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} is not a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the kernel needs D contiguous")
    if b * hq > 65535:
        raise ValueError(f"flash_attention: B*Hq={b * hq} exceeds the kernel's grid")
    if max(q.shape[2], k.shape[2]) >= 2**31:
        raise ValueError("flash_attention: sequence too long for the kernel's int rows")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: tensors on {q.device}, {k.device}, {v.device}")
    # written as (B, Sq, Hq, D): the LM's layout, so moving heads back is free
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    if out.numel():
        FLASH_FWD(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  int(q.dtype == torch.bfloat16), b, hq, hkv, sq, sk, d,
                  *(s for t in (q, k, v, out) for s in t.stride()[:3]),
                  MASKS[mask], window, kv_len, 1.0 / (d ** 0.5), stream_of(q))
    return out
