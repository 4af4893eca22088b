"""Transformer layers of the port's LM stack (the reference's
``models/layers.py``, attention, the dense MLP and the MoE layer): norms,
RoPE, attention (prefill/train through the flash kernel, cached decode,
sliding-window ring caches, cross attention to modality embeddings; in
training a backward through the reference's plain attention), the SwiGLU
MLP and the capacity-dispatched mixture of experts.

Every projection goes through the Octopus router (``core/router.matmul``),
which places it on the VPE or the AryPE engine.  The reference keeps the
QKV/O projections on XLA's dot even when its kernels are on; the port has no
such arm, so on the card they run the engine kernels like every other matmul.
Each routed matmul returns the layer input's dtype (``out_dtype=x.dtype``, as
the reference passes): bf16 under bf16 compute, summed in f32 on f32 weights
and rounded once.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.common.util import Device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import router
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.spec import ParamSpec
from repro_torch.runtime import RuntimeConfig

NEG_INF = -1e30


# ---------------------------------------------------------------- norms, RoPE


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm with the reference's ``(1 + w)`` gain (zero-initialised w)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., S, H, D) rotated over D by positions (..., S): the two halves
    of D rotate against each other (not interleaved pairs)."""
    half = x.shape[-1] // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / (theta ** exponent)  # theta as an f32 scalar, as in the reference
    angles = positions[..., :, None].float() * freqs  # (..., S, half)
    cos, sin = torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------- attention


def attn_specs(cfg: ArchConfig, *, cross: bool = False) -> dict:
    """An attention layer's parameters; a cross-attention layer's add
    ``ln_kv``, the norm of the modality embeddings its keys come from."""
    dt = cfg.param_dtype
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    specs = {
        "ln": ParamSpec((d,), ("embed",), "zeros", dtype=dt),
        "wq": ParamSpec((d, qd), ("embed", "heads"), "normal", dtype=dt),
        "wk": ParamSpec((d, kvd), ("embed", "kv_heads"), "normal", dtype=dt),
        "wv": ParamSpec((d, kvd), ("embed", "kv_heads"), "normal", dtype=dt),
        "wo": ParamSpec((qd, d), ("heads", "embed"), "normal", dtype=dt),
    }
    if cfg.use_qk_norm:
        specs["q_norm"] = ParamSpec((cfg.head_dim,), (None,), "zeros", dtype=dt)
        specs["k_norm"] = ParamSpec((cfg.head_dim,), (None,), "zeros", dtype=dt)
    if cross:
        specs["ln_kv"] = ParamSpec((d,), ("embed",), "zeros", dtype=dt)
    return specs


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, kind: str,
                   window: int = 0) -> torch.Tensor:
    """q (B, S, Hq, D) over k, v (B, Sk, Hkv, D) -> (B, S, Hq, D), through the
    flash kernel (the reference's ``use_pallas`` arm; the port has no other).
    On ``meta`` tensors (a ``RoutePlan`` trace of an LM) an empty ``meta``
    result: nothing runs."""
    if q.device.type == "meta":
        return torch.empty(q.shape, dtype=q.dtype, device="meta")
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          mask=kind, window=window)
    return out.transpose(1, 2)


# ---------------------------------------------------------------- attention, training


# the reference's attention_core chooses the materialized scores while S * Sk
# stays at or under this, else the blockwise online softmax in 512-chunks
NAIVE_MAX_SCORES = 1 << 20
TRAIN_CHUNK = 512


def _naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, kind: str,
                     window: int) -> torch.Tensor:
    """The reference's ``_naive_attention``: q (B, S, Hkv, G, D) over k, v
    (B, Sk, Hkv, D), the whole (S, Sk) score matrix in f32, an f32 AV
    product, the output in q's type."""
    b, s, hkv, g, dh = q.shape
    sk = k.shape[1]
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q.float() * float(1.0 / np.sqrt(dh)), k.float())
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    valid = torch.ones((s, sk), dtype=torch.bool, device=q.device)
    if kind == "causal":
        valid = valid & (qpos >= kpos)
    elif kind == "local":
        valid = valid & (qpos >= kpos) & (qpos - kpos < window)
    scores = torch.where(valid, scores, NEG_INF)
    p = torch.where(valid, torch.exp(scores - scores.amax(dim=-1, keepdim=True)), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p / torch.where(l == 0, 1.0, l), v.float())
    return out.to(q.dtype)


def _blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, kind: str,
                         window: int, chunk_q: int = TRAIN_CHUNK,
                         chunk_kv: int = TRAIN_CHUNK) -> torch.Tensor:
    """The reference's ``_blockwise_attention`` (its f32 ``attn_av_dtype``):
    every query chunk at once, a loop over KV chunks in place of its scan
    carrying the running max ``m``, normalizer ``l`` and accumulator, S and
    Sk padded up to whole chunks."""
    b, s, hkv, g, dh = q.shape
    sk = k.shape[1]
    cq, ck = min(chunk_q, s), min(chunk_kv, sk)
    nq, nk = -(-s // cq), -(-sk // ck)
    q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, 0, 0, nq * cq - s))
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, nk * ck - sk))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, nk * ck - sk))
    qc = q.reshape(b, nq, cq, hkv, g, dh).float() * float(1.0 / np.sqrt(dh))
    kc, vc = k.reshape(b, nk, ck, hkv, dh), v.reshape(b, nk, ck, hkv, dh)
    dev = q.device
    qpos = torch.arange(nq, device=dev)[:, None] * cq + torch.arange(cq, device=dev)[None, :]
    m = torch.full((b, nq, hkv, g, cq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, nq, hkv, g, cq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, nq, hkv, g, cq, dh), dtype=torch.float32, device=dev)
    for j in range(nk):
        scores = torch.einsum("bnqhgd,bkhd->bnhgqk", qc, kc[:, j].float())
        kpos = j * ck + torch.arange(ck, device=dev)
        valid = (kpos[None, None] < sk) & torch.ones((nq, cq, ck), dtype=torch.bool, device=dev)
        if kind == "causal":
            valid = valid & (qpos[:, :, None] >= kpos[None, None, :])
        elif kind == "local":
            dpos = qpos[:, :, None] - kpos[None, None, :]
            valid = valid & (dpos >= 0) & (dpos < window)
        valid = valid[None, :, None, None]
        scores = torch.where(valid, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.where(valid, torch.exp(scores - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bnhgqk,bkhd->bnhgqd", p, vc[:, j].float())
        m = m_new
    out = (acc / torch.where(l == 0, 1.0, l)[..., None]).to(q.dtype)  # (b, nq, hkv, g, cq, dh)
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(b, nq * cq, hkv, g, dh)
    return out[:, :s]


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, kind: str,
                        window: int = 0) -> torch.Tensor:
    """The reference's training attention (``attention_core`` without
    ``use_pallas``), plain PyTorch: KV heads repeated to q's (GQA), then the
    naive scores where S * Sk <= :data:`NAIVE_MAX_SCORES`, else blockwise.
    q (B, S, Hq, D), k, v (B, Sk, Hkv, D) -> (B, S, Hq, D)."""
    b, s, hq, dh = q.shape
    g = hq // k.shape[2]
    if g > 1:
        k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    qg = q.reshape(b, s, hq, 1, dh)
    attend = _naive_attention if s * k.shape[1] <= NAIVE_MAX_SCORES else _blockwise_attention
    return attend(qg, k, v, kind=kind, window=window).reshape(b, s, hq, dh)


class TrainAttention(torch.autograd.Function):
    """Attention for autograd: the forward is :func:`attention_core` (the
    flash kernel on the card); the backward recomputes the reference's
    training arm, :func:`reference_attention`, under autograd and pulls the
    cotangent back through it (the reference has no backward kernel to
    port).  dq, dk, dv come back in q's type."""

    @staticmethod
    def forward(ctx, q, k, v, kind: str, window: int):
        ctx.save_for_backward(q, k, v)
        ctx.kind, ctx.window = kind, window
        return attention_core(q, k, v, kind=kind, window=window)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = reference_attention(q, k, v, kind=ctx.kind, window=ctx.window)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype), None, None


def attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, kind: str,
                    window: int = 0) -> torch.Tensor:
    """:func:`attention_core` in ``mode="train"``: through
    :class:`TrainAttention` where autograd needs its backward, else the
    forward alone."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return TrainAttention.apply(q, k, v, kind, window)
    return attention_core(q, k, v, kind=kind, window=window)


class AttnCache(NamedTuple):
    k: torch.Tensor  # (B, C, Hkv, D): C = full length (global) or window (local ring)
    v: torch.Tensor
    pos: torch.Tensor  # (B, C) int32 absolute position in each slot (-1 = empty)


def init_attn_cache(cfg: ArchConfig, batch: int, cache_len: int, *, kind: str,
                    device: Device, dtype: torch.dtype = torch.bfloat16) -> AttnCache:
    """An empty cache.  Its K/V are bf16 whatever the compute type, as the
    reference's (so decode attends to bf16-rounded keys and values)."""
    c = min(cache_len, cfg.window_size) if kind == "local" and cfg.window_size else cache_len
    shape = (batch, c, cfg.num_kv_heads, cfg.head_dim)
    return AttnCache(k=torch.zeros(shape, dtype=dtype, device=device),
                     v=torch.zeros(shape, dtype=dtype, device=device),
                     pos=torch.full((batch, c), -1, dtype=torch.int32, device=device))


def cache_write(cache: AttnCache, k_new: torch.Tensor, v_new: torch.Tensor,
                lengths: torch.Tensor, *, kind: str) -> AttnCache:
    """Write S_new tokens at per-sample positions lengths..lengths+S_new-1,
    in place (the reference returns a new cache).  A local cache is a ring
    indexed by position % C; a global one clamps at C - 1.  Where several
    tokens land in one slot the last one stays, as in the reference's
    sequential scatter: a ring keeps only the last C tokens of a write, and a
    global cache writes its last token once more after the others.  Nothing
    here waits for the device."""
    s_new, cap = k_new.shape[1], cache.k.shape[1]
    if kind == "local" and s_new > cap:
        k_new, v_new = k_new[:, s_new - cap:], v_new[:, s_new - cap:]
        lengths, s_new = lengths + (s_new - cap), cap
    abs_pos = lengths.long()[:, None] + torch.arange(s_new, device=lengths.device)[None, :]
    idx = abs_pos % cap if kind == "local" else torch.clamp_max(abs_pos, cap - 1)
    bidx = torch.arange(k_new.shape[0], device=lengths.device)[:, None].expand_as(idx)
    parts = [slice(None)] + ([slice(s_new - 1, None)] if kind != "local" and s_new > 1 else [])
    for part in parts:
        sel = (bidx[:, part], idx[:, part])
        cache.k[sel] = k_new[:, part].to(cache.k.dtype)
        cache.v[sel] = v_new[:, part].to(cache.v.dtype)
        cache.pos[sel] = abs_pos[:, part].to(torch.int32)
    return cache


def attention_decode(q: torch.Tensor, cache: AttnCache, lengths: torch.Tensor, *, kind: str,
                     window: int = 0) -> torch.Tensor:
    """q (B, S_new, Hq, D) over the cache, masked by the positions it holds
    (-1 empty, keys at or before the query, within the window for local).
    Plain PyTorch, as the reference computes it outside any kernel."""
    b, sn, hq, dh = q.shape
    hkv = cache.k.shape[2]
    qg = q.reshape(b, sn, hkv, hq // hkv, dh).float() * float(1.0 / np.sqrt(dh))
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, cache.k.float())
    qpos = lengths.long()[:, None] + torch.arange(sn, device=q.device)[None, :]
    kpos = cache.pos.long()
    valid = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= qpos[:, :, None])
    if kind == "local":
        valid = valid & ((qpos[:, :, None] - kpos[:, None, :]) < window)
    valid = valid[:, None, None]
    s = torch.where(valid, s, NEG_INF)
    p = torch.where(valid, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p / torch.where(l == 0, 1.0, l), cache.v.float())
    return out.to(q.dtype).reshape(b, sn, hq, dh)


def _cross_attn(p: dict, x: torch.Tensor, q: torch.Tensor, cfg: ArchConfig, mm, *,
                cross_kv: Optional[torch.Tensor], cache: Optional[AttnCache],
                mode: str) -> tuple[torch.Tensor, Optional[AttnCache]]:
    """The cross branch of :func:`attn_apply`, line by line the reference's:
    training and prefill project k and v from the normed modality embeddings
    ``cross_kv`` (B, T, D) (no rope), and prefill returns them as the cache,
    in the type the projections return (the compute type), positions 0..T-1;
    decode attends the cached k and v and returns the cache unchanged.  Every
    query attends every key (the full mask), through the flash kernel in all
    three modes, as the reference's ``attention_core``.  Under
    ``use_qk_norm`` the keys are normed after the cache is built, and decode
    does not norm the cached keys: decode then attends un-normed keys where
    prefill attended normed ones, as the reference does (ROADMAP Queue 3)."""
    b, s, _ = x.shape
    if mode == "decode":
        if cache is None:
            raise ValueError("attn_apply: a cross decode needs the cache its prefill made")
        k, v = cache.k, cache.v
    else:
        if cross_kv is None:
            raise ValueError(f"attn_apply: cross attention in mode {mode!r} needs cross_kv "
                             "(the batch's 'vision' embeddings)")
        kvsrc = rms_norm(cross_kv, p["ln_kv"])
        t = kvsrc.shape[1]
        k = mm(kvsrc, p["wk"]).reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
        v = mm(kvsrc, p["wv"]).reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
        pos = torch.arange(t, dtype=torch.int32, device=x.device).repeat(b, 1)
        cache = AttnCache(k=k, v=v, pos=pos)
    if cfg.use_qk_norm:
        q = rms_norm(q, p["q_norm"])
        if mode != "decode":
            k = rms_norm(k, p["k_norm"])
    attend = attention_train if mode == "train" else attention_core
    out = attend(q, k, v, kind="full")
    out = mm(out.reshape(b, s, cfg.q_dim), p["wo"])
    return x + out, (cache if mode != "train" else None)


def attn_apply(p: dict, x: torch.Tensor, cfg: ArchConfig, *, kind: str,
               cross_kv: Optional[torch.Tensor] = None, cache: Optional[AttnCache] = None,
               lengths: Optional[torch.Tensor] = None,
               mode: str = "train") -> tuple[torch.Tensor, Optional[AttnCache]]:
    """One attention layer on x (B, S, D) at positions lengths.. (0.. in
    training); ``kind`` causal|local|full|cross (cross: over the modality
    embeddings ``cross_kv`` (B, T, D), :func:`_cross_attn`), ``mode``
    train|prefill|decode.  Returns (x + attention, the cache)."""
    b, s, _ = x.shape
    mm = functools.partial(router.matmul, out_dtype=x.dtype, config=RuntimeConfig.from_arch(cfg))
    h = rms_norm(x, p["ln"])
    q = mm(h, p["wq"]).reshape(b, s, cfg.num_heads, cfg.head_dim)
    if kind == "cross":
        return _cross_attn(p, x, q, cfg, mm, cross_kv=cross_kv, cache=cache, mode=mode)
    k = mm(h, p["wk"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = mm(h, p["wv"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    if cfg.use_qk_norm:
        q, k = rms_norm(q, p["q_norm"]), rms_norm(k, p["k_norm"])
    base = torch.zeros(b, dtype=torch.int32, device=x.device) if lengths is None else lengths
    positions = base[:, None] + torch.arange(s, device=x.device)[None, :]
    theta = cfg.rope_theta_local if kind == "local" else cfg.rope_theta
    q, k = apply_rope(q, positions, theta), apply_rope(k, positions, theta)
    attn_kind = "full" if (kind == "causal" and not cfg.causal) else kind
    if mode == "train":
        out = attention_train(q, k, v, kind=attn_kind, window=cfg.window_size)
    else:
        if cache is None or lengths is None:
            raise ValueError(f"attn_apply: mode {mode!r} needs a cache and lengths")
        cache = cache_write(cache, k, v, lengths, kind=attn_kind)
        if mode == "prefill":
            out = attention_core(q, k, v, kind=attn_kind, window=cfg.window_size)
        else:
            out = attention_decode(q, cache, lengths, kind=attn_kind, window=cfg.window_size)
    out = mm(out.reshape(b, s, cfg.q_dim), p["wo"])
    return x + out, (cache if mode != "train" else None)


# ---------------------------------------------------------------- dense MLP


def mlp_specs(cfg: ArchConfig, d_ff: Optional[int] = None) -> dict:
    """The MLP's parameters, ``d_ff`` wide (``cfg.d_ff`` by default)."""
    dt = cfg.param_dtype
    d, f = cfg.d_model, d_ff or cfg.d_ff
    specs = {
        "ln": ParamSpec((d,), ("embed",), "zeros", dtype=dt),
        "wi_up": ParamSpec((d, f), ("embed", "mlp"), "normal", dtype=dt),
        "wo": ParamSpec((f, d), ("mlp", "embed"), "normal", dtype=dt),
    }
    if cfg.mlp_gated:
        specs["wi_gate"] = ParamSpec((d, f), ("embed", "mlp"), "normal", dtype=dt)
    return specs


def mlp_apply(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x + SwiGLU MLP (gelu MLP when not gated), every matmul routed."""
    mm = functools.partial(router.matmul, out_dtype=x.dtype, config=RuntimeConfig.from_arch(cfg))
    h = rms_norm(x, p["ln"])
    if cfg.mlp_gated:
        gate = mm(h, p["wi_gate"], activation="silu")
        up = mm(h, p["wi_up"])
        return x + mm(gate * up, p["wo"])
    up = mm(h, p["wi_up"], activation="gelu")
    return x + mm(up, p["wo"])


# ---------------------------------------------------------------- mixture of experts


def moe_specs(cfg: ArchConfig) -> dict:
    dt = cfg.param_dtype
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    specs = {
        "ln": ParamSpec((d,), ("embed",), "zeros", dtype=dt),
        "router": ParamSpec((d, e), ("embed", None), "small_normal", dtype="float32"),
        "w_gate": ParamSpec((e, d, f), ("expert", "embed", "mlp"), "normal", dtype=dt),
        "w_up": ParamSpec((e, d, f), ("expert", "embed", "mlp"), "normal", dtype=dt),
        "w_down": ParamSpec((e, f, d), ("expert", "mlp", "embed"), "normal", dtype=dt),
    }
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        specs["sh_gate"] = ParamSpec((d, fs), ("embed", "mlp"), "normal", dtype=dt)
        specs["sh_up"] = ParamSpec((d, fs), ("embed", "mlp"), "normal", dtype=dt)
        specs["sh_down"] = ParamSpec((fs, d), ("mlp", "embed"), "normal", dtype=dt)
    return specs


def moe_capacity(tokens_per_group: int, cfg: ArchConfig) -> int:
    """Slots per expert per group: ``ceil(T * k / E * capacity_factor)``, at
    least 1 (the reference's double-precision arithmetic)."""
    c = math.ceil(tokens_per_group * cfg.experts_per_token / cfg.num_experts
                  * cfg.capacity_factor)
    return max(c, 1)


def _dispatch_indices(eidx: torch.Tensor, e: int, cap: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """eidx (..., TK) expert id of each routing entry -> (slot, keep), each
    (..., TK), over the last axis: an entry's slot is ``expert * cap +`` its
    position among the entries of its expert in entry order; entries past
    ``cap`` are dropped (``keep`` False) and get the drop row ``e * cap``.
    The reference's stable argsort, left ``searchsorted`` and inverse
    permutation, all integer work, so the result is exact."""
    tk = eidx.shape[-1]
    eidx = eidx.long()
    order = torch.sort(eidx, dim=-1, stable=True).indices
    sorted_e = torch.gather(eidx, -1, order)
    experts = torch.arange(e, device=eidx.device).expand(*eidx.shape[:-1], e).contiguous()
    starts = torch.searchsorted(sorted_e.contiguous(), experts)
    pos = torch.arange(tk, device=eidx.device) - torch.gather(starts, -1, sorted_e)
    keep_sorted = pos < cap
    slot_sorted = torch.where(keep_sorted, sorted_e * cap + pos, e * cap)
    # the inverse permutation: entry order[i] takes sorted position i's values
    slot = torch.empty_like(slot_sorted).scatter_(-1, order, slot_sorted)
    keep = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
    return slot, keep


def moe_route(router_w: torch.Tensor, hg: torch.Tensor, k_top: int
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router on normed tokens hg (G, T, D): (probs (G, T, E), the top
    ``k_top`` gates renormalised to sum 1, their expert ids (G, T, k_top)).
    The logits are f32 (hg upcast, exactly, as the reference's astype).  A
    stable descending sort puts equal probabilities in expert order, as
    ``lax.top_k`` does (``torch.topk`` promises no order, and the order of
    the entries decides which ones a full expert drops)."""
    logits = torch.einsum("gtd,de->gte", hg.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, top_idx = gate_vals[..., :k_top], top_idx[..., :k_top]
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)
    return probs, gate_vals, top_idx


def moe_apply(p: dict, x: torch.Tensor, cfg: ArchConfig,
              num_groups: Optional[int] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x + the MoE layer on x (B, S, D), and the Switch-style load-balance
    aux loss (f32 scalar).

    Tokens split into G groups (B for prefill, min(B, 8) for decode, as the
    reference's); each expert takes at most ``moe_capacity(T)`` entries a
    group, in entry order, and the rest drop.  The router logits and the
    expert products are plain products outside any kernel in the reference,
    so they stay ``torch.einsum``; the shared experts go through
    ``router.matmul``.  Types follow the reference's promotions: a bf16 x
    meets f32 expert weights in f32 and bf16 ones in bf16 (each product
    summed in f32 and rounded once to that type, as XLA computes a bf16
    ``einsum``), and values round only there and where the reference
    writes ``astype``: the gated product to x's dtype, the combine in
    ``moe_combine_dtype``, the output to x's dtype.  The combine
    adds each token's k entries in entry order (the reference scatter-adds
    them into zeros; a CUDA ``index_add_`` would add them in any order)."""
    b, s, d = x.shape
    e, k_top = cfg.num_experts, cfg.experts_per_token
    g = num_groups if num_groups is not None else (b if s > 1 else max(1, min(b, 8)))
    if (b * s) % g:
        raise ValueError(f"moe_apply: {b * s} tokens do not split into {g} groups")
    t = (b * s) // g
    cap = moe_capacity(t, cfg)
    h = rms_norm(x, p["ln"])
    hg = h.reshape(g, t, d)
    probs, gate_vals, top_idx = moe_route(p["router"], hg, k_top)

    # load-balance aux: each expert's share of the entries times its mean prob
    eidx = top_idx.reshape(g, t * k_top)
    counts = torch.zeros(g, e, dtype=torch.float32, device=x.device)
    counts.scatter_add_(1, eidx, torch.ones_like(eidx, dtype=torch.float32))
    density = counts / (t * k_top)
    aux = e * torch.mean(torch.sum(density * probs.mean(dim=1), dim=-1))

    slot, keep = _dispatch_indices(eidx, e, cap)
    tok = torch.arange(t * k_top, device=x.device) // k_top  # the token of each entry
    src = hg[:, tok] * keep[..., None].to(hg.dtype)  # (G, TK, D)
    buf = torch.zeros(g, e * cap + 1, d, dtype=hg.dtype, device=x.device)
    buf.scatter_(1, slot[..., None].expand(-1, -1, d), src)  # the drop row takes the rest
    disp = buf[:, :e * cap].reshape(g, e, cap, d).float()

    def expert_mm(spec: str, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return torch.einsum(spec, a, w.float()).to(torch.promote_types(hg.dtype, w.dtype))

    gate = expert_mm("gecd,edf->gecf", disp, p["w_gate"])
    # silu as jax.nn.sigmoid lowers it, each op rounded to gate's type: on
    # bf16 experts the one-rounding torch.sigmoid differs on ~30% of values
    gate = gate * (1 / (1 + torch.exp(-gate)))
    up = expert_mm("gecd,edf->gecf", disp, p["w_up"])
    out_e = expert_mm("gecf,efd->gecd", (gate * up).to(hg.dtype).float(), p["w_down"])

    cdt = getattr(torch, cfg.moe_combine_dtype)
    weights = (gate_vals.reshape(g, t * k_top) * keep.float()).to(cdt)
    flat = torch.cat([out_e.reshape(g, e * cap, d),
                      torch.zeros(g, 1, d, dtype=out_e.dtype, device=x.device)], dim=1)
    gathered = (torch.gather(flat, 1, slot[..., None].expand(-1, -1, d)).to(cdt)
                * weights[..., None]).reshape(g, t, k_top, d)
    y = gathered[:, :, 0]
    for j in range(1, k_top):
        y = y + gathered[:, :, j]
    y = y.to(x.dtype)

    if cfg.num_shared_experts:
        mm = functools.partial(router.matmul, out_dtype=x.dtype,
                               config=RuntimeConfig.from_arch(cfg))
        sg = mm(hg, p["sh_gate"], activation="silu")
        su = mm(hg, p["sh_up"])
        y = y + mm(sg * su, p["sh_down"])
    return x + y.reshape(b, s, d), aux
