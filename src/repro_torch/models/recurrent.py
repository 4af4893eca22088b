"""Recurrent mixers of the port's LM stack (the reference's
``models/recurrent.py``): Mamba-2 (the chunked state-space-duality scan),
xLSTM's mLSTM (the chunkwise-parallel scan, stabilised in log space) and
sLSTM (a sequential scan).

Each mixer has the attention layers' interface:

  *_specs(cfg)                        the parameter spec tree
  *_apply(p, x, cfg, mode, cache)     -> (x + mixer(x), the new cache)

The caches are fixed-size recurrent states, so a decode step costs the same
whatever the history.  ``*_apply`` returns a new state (tensors of its own);
the model writes it into its cache (``transformer.store_rows``).

Every projection the reference routes (``in_proj``, ``out_proj``, ``w_up``,
``w_down``, ``w_gates``) goes through ``core/router.matmul`` into the
layer input's dtype, as the reference passes it.  The rest has no kernel
behind it in the reference (no ``pallas_call``), so it stays plain
PyTorch: the headwise q/k projections, the gates, the convolution and the
scans.  Types follow JAX's promotions: a bf16 activation meets an f32
weight in f32 and rounds where the reference writes ``astype``.  The
activations are written as JAX computes them: ``softplus`` as
``logaddexp(x, 0)`` (``F.softplus`` switches to x past 20) and
``log_sigmoid`` as ``-softplus(-x)``; ``sigmoid`` is ``torch.sigmoid``,
which agrees with XLA's f32 ``logistic`` on all but a few values in a
thousand (its op-by-op ``1 / (1 + exp(-x))`` on 4 in a hundred), and every
sigmoid here runs in f32.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common.util import ceil_div
from repro_torch.configs.base import ArchConfig
from repro_torch.core import router
from repro_torch.models.layers import rms_norm
from repro_torch.models.spec import ParamSpec
from repro_torch.runtime import RuntimeConfig


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -softplus(-x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * sigmoid(x)``."""
    return x * torch.sigmoid(x)


def _einsum(spec: str, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A plain product of an activation and a weight as ``jnp.einsum``
    types it: summed in f32, in the promoted type of the two (f32 for a
    bf16 activation on f32 weights)."""
    return torch.einsum(spec, a.float(), w.float()).to(torch.promote_types(a.dtype, w.dtype))


def _routed(cfg: ArchConfig, x: torch.Tensor):
    """The layer's routed matmul into x's dtype, as the reference's
    ``functools.partial(router.matmul, out_dtype=x.dtype, ...)``."""
    return functools.partial(router.matmul, out_dtype=x.dtype, config=RuntimeConfig.from_arch(cfg))


def _pad_seq(t: torch.Tensor, pad: int, value: float = 0.0) -> torch.Tensor:
    """``t`` (B, S, ...) with ``pad`` rows of ``value`` after S."""
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad), value=value)


# ---------------------------------------------------------------- Mamba-2 (SSD)


class Mamba2Cache(NamedTuple):
    ssm: torch.Tensor  # (B, H, N, P) f32 state
    conv: torch.Tensor  # (B, W-1, conv_dim) the last conv inputs


def mamba2_specs(cfg: ArchConfig) -> dict:
    dt = cfg.param_dtype
    d, din, n, h = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = din + 2 * n
    in_dim = 2 * din + 2 * n + h  # z, x, B, C, dt
    return {
        "ln": ParamSpec((d,), ("embed",), "zeros", dtype=dt),
        "in_proj": ParamSpec((d, in_dim), ("embed", "ssm_inner"), "normal", dtype=dt),
        "conv_w": ParamSpec((cfg.ssm_conv_width, conv_dim), (None, "ssm_inner"), "small_normal",
                            dtype=dt),
        "conv_b": ParamSpec((conv_dim,), ("ssm_inner",), "zeros", dtype=dt),
        "a_log": ParamSpec((h,), (None,), "mamba_alog", dtype="float32"),
        "d_skip": ParamSpec((h,), (None,), "ones", dtype="float32"),
        "dt_bias": ParamSpec((h,), (None,), "mamba_dt", dtype="float32"),
        "norm": ParamSpec((din,), ("ssm_inner",), "zeros", dtype=dt),
        "out_proj": ParamSpec((din, d), ("ssm_inner", "embed"), "normal", dtype=dt),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along S, x (B, S, C), w (W, C); returns (y in
    x's dtype, the new state: the last W - 1 inputs).  The state joins x in
    their promoted type, as ``jnp.concatenate`` does: a bf16 state before
    f32 inputs comes back f32."""
    bsz, s, c = x.shape
    width = w.shape[0]
    if state is None:
        state = torch.zeros((bsz, width - 1, c), dtype=x.dtype, device=x.device)
    dt = torch.promote_types(state.dtype, x.dtype)
    xp = torch.cat([state.to(dt), x.to(dt)], dim=1)  # (B, S+W-1, C)
    y = torch.zeros((bsz, s, c), dtype=torch.float32, device=x.device)
    for i in range(width):
        y = y + xp[:, i:i + s, :].float() * w[i].float()
    y = silu(y + b.float())
    new_state = xp[:, -(width - 1):, :] if width > 1 else state
    return y.to(x.dtype), new_state


def _ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_in: torch.Tensor,
                 c_in: torch.Tensor, chunk: int, state0: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked state-space-duality scan.  xh (B, S, H, P); dt (B, S, H)
    after the softplus; a (H,) negative; b_in, c_in (B, S, N) f32; state0
    (B, H, N, P).  S pads with zeros to whole chunks of ``min(chunk, S)``.
    Returns (y (B, S, H, P) f32, the final state (B, H, N, P))."""
    bsz, s, h, p = xh.shape
    n = b_in.shape[-1]
    L = min(chunk, s)
    nc = ceil_div(s, L)
    pad = nc * L - s
    if pad:
        xh, dt, b_in, c_in = (_pad_seq(t, pad) for t in (xh, dt, b_in, c_in))
    xc = xh.reshape(bsz, nc, L, h, p).float()
    dtc = dt.reshape(bsz, nc, L, h)
    bc = b_in.reshape(bsz, nc, L, n)
    cc = c_in.reshape(bsz, nc, L, n)

    da = dtc * a  # (B, nc, L, H) negative decay increments
    cum = torch.cumsum(da, dim=2)  # inclusive within a chunk
    total = cum[:, :, -1:, :]  # (B, nc, 1, H)

    # within a chunk: att[t, s] = exp(cum_t - cum_s) * (c_t . b_s) * dt_s for s <= t
    decay = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])  # (B, nc, L, L, H)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=xh.device))
    cb = torch.einsum("bcln,bcmn->bclm", cc, bc)
    att = cb[..., None] * decay * dtc[:, :, None, :, :]
    att = torch.where(tri[None, None, :, :, None], att, 0.0)
    y_diag = torch.einsum("bclmh,bcmhp->bclhp", att, xc)

    # each chunk's outgoing state: sum_s exp(total - cum_s) * dt_s * b_s (x) x_s
    w_out = torch.exp(total - cum) * dtc
    chunk_states = torch.einsum("bclh,bcln,bclhp->bchnp", w_out, bc, xc)

    # across chunks (the reference's scan): each chunk reads its incoming state
    st, in_states = state0, []
    for j in range(nc):
        in_states.append(st)
        st = torch.exp(total[:, j, 0, :])[:, :, None, None] * st + chunk_states[:, j]
    y_off = torch.einsum("bcln,bclh,bchnp->bclhp", cc, torch.exp(cum),
                         torch.stack(in_states, dim=1))
    y = (y_diag + y_off).reshape(bsz, nc * L, h, p)[:, :s]
    return y, st


def mamba2_apply(p: dict, x: torch.Tensor, cfg: ArchConfig, *, mode: str = "train",
                 cache: Optional[Mamba2Cache] = None
                 ) -> tuple[torch.Tensor, Optional[Mamba2Cache]]:
    """One Mamba-2 layer on x (B, S, D): a decode step of one token runs the
    single-step recurrence, anything else the chunked scan from the cache's
    state (zeros without one)."""
    bsz, s, _ = x.shape
    din, n, h, pdim = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    mm = _routed(cfg, x)
    proj = mm(rms_norm(x, p["ln"]), p["in_proj"])
    z, xs, b_in, c_in, dt = torch.split(proj, [din, din, n, n, h], dim=-1)

    conv_out, new_conv = _causal_conv(torch.cat([xs, b_in, c_in], dim=-1), p["conv_w"],
                                      p["conv_b"], cache.conv if cache is not None else None)
    xs, b_in, c_in = torch.split(conv_out, [din, n, n], dim=-1)

    a = -torch.exp(p["a_log"])  # (H,)
    dtp = softplus(dt.float() + p["dt_bias"])  # (B, S, H)
    xh = xs.reshape(bsz, s, h, pdim)
    state0 = cache.ssm if cache is not None else torch.zeros(
        (bsz, h, n, pdim), dtype=torch.float32, device=x.device)
    if mode == "decode" and s == 1:
        da = torch.exp(dtp[:, 0, :] * a)  # (B, H)
        dbx = torch.einsum("bh,bn,bhp->bhnp", dtp[:, 0], b_in[:, 0].float(), xh[:, 0].float())
        new_state = da[:, :, None, None] * state0 + dbx
        y = torch.einsum("bn,bhnp->bhp", c_in[:, 0].float(), new_state)[:, None]
    else:
        y, new_state = _ssd_chunked(xh, dtp, a, b_in.float(), c_in.float(), cfg.ssm_chunk,
                                    state0)
    y = y + p["d_skip"][None, None, :, None] * xh.float()
    y = y.reshape(bsz, s, din).to(x.dtype)
    y = rms_norm(y * silu(z.float()).to(x.dtype), p["norm"])
    out = x + mm(y, p["out_proj"])
    return out, (Mamba2Cache(ssm=new_state, conv=new_conv) if mode != "train" else None)


def init_mamba2_cache(cfg: ArchConfig, batch: int, *, device) -> Mamba2Cache:
    """A zero state; the conv inputs in bf16, as the reference keeps them
    (f32 compute writes them back in f32: ``_causal_conv``)."""
    conv_dim = cfg.ssm_d_inner + 2 * cfg.ssm_state
    return Mamba2Cache(
        ssm=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
                        dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim), dtype=torch.bfloat16,
                         device=device),
    )


# ---------------------------------------------------------------- xLSTM: mLSTM


class MLSTMCache(NamedTuple):
    c: torch.Tensor  # (B, H, DK, DV) stabilised matrix memory
    n: torch.Tensor  # (B, H, DK) normaliser
    m: torch.Tensor  # (B, H) log-space stabiliser


def mlstm_specs(cfg: ArchConfig) -> dict:
    dt = cfg.param_dtype
    d, din, h = cfg.d_model, cfg.mlstm_d_inner, cfg.num_heads
    dk = din // h
    return {
        "ln": ParamSpec((d,), ("embed",), "zeros", dtype=dt),
        "w_up": ParamSpec((d, 2 * din), ("embed", "mlstm_inner"), "normal", dtype=dt),
        # headwise (block-diagonal) q/k projections, as in the xLSTM paper
        "wq": ParamSpec((h, dk, dk), (None, "mlstm_qk", None), "normal", dtype=dt),
        "wk": ParamSpec((h, dk, dk), (None, "mlstm_qk", None), "normal", dtype=dt),
        "w_if": ParamSpec((din, 2 * h), ("mlstm_inner", None), "small_normal", dtype="float32"),
        "if_bias": ParamSpec((2 * h,), (None,), "zeros", dtype="float32"),
        "mnorm": ParamSpec((din,), ("mlstm_inner",), "zeros", dtype=dt),
        "w_down": ParamSpec((din, d), ("mlstm_inner", "embed"), "normal", dtype=dt),
    }


def _mlstm_chunk_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ig: torch.Tensor,
                      lf: torch.Tensor, chunk: int, cache: MLSTMCache
                      ) -> tuple[torch.Tensor, MLSTMCache]:
    """The chunkwise-parallel stabilised mLSTM.  q, k, v (B, S, H, D); ig
    (B, S, H) the raw input-gate preactivation; lf (B, S, H) the log-sigmoid
    forget gate.  S pads to whole chunks of ``min(chunk, S)`` with q, k, v
    and lf 0 and ig -1e9 (a padded step writes nothing).  Returns (h (B, S,
    H, D) f32, the cache after the last step)."""
    bsz, s, h, dk = q.shape
    dv = v.shape[-1]
    L = min(chunk, s)
    nc = ceil_div(s, L)
    pad = nc * L - s
    if pad:
        q, k, v, lf = (_pad_seq(t, pad) for t in (q, k, v, lf))
        ig = _pad_seq(ig, pad, -1e9)
    shp = (bsz, nc, L)
    qc = q.reshape(*shp, h, dk).float() / float(np.float32(np.sqrt(dk)))
    kc = k.reshape(*shp, h, dk).float()
    vc = v.reshape(*shp, h, dv).float()
    igc, lfc = ig.reshape(*shp, h), lf.reshape(*shp, h)

    bcum = torch.cumsum(lfc, dim=2)  # (B, nc, L, H) inclusive log-decay
    btot = bcum[:, :, -1, :]  # (B, nc, H)
    u = igc - bcum  # the source term in log space
    ucmax = torch.cummax(u, dim=2).values
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))[None, :, :, None]

    c_in, n_in, m_in = cache
    hs = []
    for j in range(nc):  # the reference's scan over the chunks
        qj, kj, vj, bj, uj, ujmax, btj = (t[:, j] for t in (qc, kc, vc, bcum, u, ucmax, btot))
        # each position's stabiliser: mq_t = b_t + max(m_in, cummax_{s<=t} u_s)
        mq = bj + torch.maximum(m_in[:, None, :], ujmax)  # (B, L, H)
        # the gate matrix within the chunk: exp(b_t - b_s + i_s - mq_t) for s <= t
        glog = bj[:, :, None, :] + uj[:, None, :, :] - mq[:, :, None, :]
        gmat = torch.where(tri, torch.exp(glog), 0.0)  # (B, L, L, H)
        scores = torch.einsum("blhd,bmhd->blmh", qj, kj) * gmat
        num_intra = torch.einsum("blmh,bmhp->blhp", scores, vj)
        den_intra = scores.sum(dim=2)
        # the incoming state's part, scaled by exp(b_t + m_in - mq_t)
        w_in = torch.exp(bj + m_in[:, None, :] - mq)  # (B, L, H)
        num_inter = torch.einsum("blhd,bhdp->blhp", qj, c_in) * w_in[..., None]
        den_inter = torch.einsum("blhd,bhd->blh", qj, n_in) * w_in
        num, den = num_intra + num_inter, den_intra + den_inter
        hs.append(num / torch.maximum(den.abs(), torch.exp(-mq))[..., None])
        # the state at the chunk's exit
        m_out = btj + torch.maximum(m_in, ujmax[:, -1, :])  # (B, H)
        w_state = torch.exp(btj[:, None, :] + uj - m_out[:, None, :])
        carry = torch.exp(btj + m_in - m_out)
        c_in = (carry[:, :, None, None] * c_in
                + torch.einsum("blh,blhd,blhp->bhdp", w_state, kj, vj))
        n_in = carry[:, :, None] * n_in + torch.einsum("blh,blhd->bhd", w_state, kj)
        m_in = m_out
    out = torch.stack(hs, dim=1).reshape(bsz, nc * L, h, dv)[:, :s]
    return out, MLSTMCache(c=c_in, n=n_in, m=m_in)


def mlstm_apply(p: dict, x: torch.Tensor, cfg: ArchConfig, *, mode: str = "train",
                cache: Optional[MLSTMCache] = None
                ) -> tuple[torch.Tensor, Optional[MLSTMCache]]:
    """One mLSTM layer on x (B, S, D), from the cache's state (the empty
    state without one); every mode runs the chunkwise scan."""
    bsz, s, _ = x.shape
    din, h = cfg.mlstm_d_inner, cfg.num_heads
    dk = din // h
    mm = _routed(cfg, x)
    up = mm(rms_norm(x, p["ln"]), p["w_up"])
    xs, z = torch.chunk(up, 2, dim=-1)  # the cell path, the gate path
    xh = xs.reshape(bsz, s, h, dk)
    q = _einsum("bshd,hde->bshe", xh, p["wq"]).to(x.dtype)
    k = _einsum("bshd,hde->bshe", xh, p["wk"]).to(x.dtype)
    gates = _einsum("bsd,dg->bsg", xs.float(), p["w_if"]) + p["if_bias"]
    ig, fg = torch.chunk(gates, 2, dim=-1)  # (B, S, H) each
    c0 = cache if cache is not None else init_mlstm_cache(cfg, bsz, device=x.device)
    hs, new_cache = _mlstm_chunk_scan(q, k, xh, ig, log_sigmoid(fg), cfg.ssm_chunk or 256, c0)
    hs = hs.reshape(bsz, s, din).to(x.dtype)
    hs = rms_norm(hs, p["mnorm"]) * silu(z.float()).to(x.dtype)
    out = x + mm(hs, p["w_down"])
    return out, (new_cache if mode != "train" else None)


def init_mlstm_cache(cfg: ArchConfig, batch: int, *, device) -> MLSTMCache:
    h = cfg.num_heads
    dk = cfg.mlstm_d_inner // h
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMCache(c=torch.zeros((batch, h, dk, dk), **f32),
                      n=torch.zeros((batch, h, dk), **f32),
                      m=torch.full((batch, h), -1e30, **f32))


# ---------------------------------------------------------------- xLSTM: sLSTM


class SLSTMCache(NamedTuple):
    c: torch.Tensor  # (B, H, D)
    n: torch.Tensor  # (B, H, D)
    m: torch.Tensor  # (B, H, D)
    h: torch.Tensor  # (B, H, D) the hidden state (the recurrent input)


def slstm_specs(cfg: ArchConfig) -> dict:
    dt = cfg.param_dtype
    d, h = cfg.d_model, cfg.num_heads
    hd = d // h
    return {
        "ln": ParamSpec((d,), ("embed",), "zeros", dtype=dt),
        "w_gates": ParamSpec((d, 4 * d), ("embed", "slstm_gates"), "normal", dtype=dt),
        "r_gates": ParamSpec((h, hd, 4 * hd), (None, None, None), "small_normal",
                             dtype="float32"),
        "gnorm": ParamSpec((d,), ("embed",), "zeros", dtype=dt),
        "w_down": ParamSpec((d, d), ("embed", "embed_out"), "normal", dtype=dt),
    }


def _slstm_cell(wx_t: torch.Tensor, r: torch.Tensor, st: SLSTMCache) -> SLSTMCache:
    """One step: wx_t (B, H, 4 HD) the input's gate contributions, r (H, HD,
    4 HD) the recurrent weights."""
    pre = wx_t.float() + torch.einsum("bhd,hdg->bhg", st.h, r.float())
    i_raw, f_raw, z_raw, o_raw = torch.chunk(pre, 4, dim=-1)
    lf = log_sigmoid(f_raw)
    m_new = torch.maximum(lf + st.m, i_raw)
    i_g = torch.exp(i_raw - m_new)
    f_g = torch.exp(lf + st.m - m_new)
    c_new = f_g * st.c + i_g * torch.tanh(z_raw)
    n_new = f_g * st.n + i_g
    # torch.maximum, not clamp: at a tie (n_new is exactly 1 after the first
    # step) it splits the gradient in halves, as jnp.maximum does
    h_new = torch.sigmoid(o_raw) * c_new / torch.maximum(n_new, torch.ones_like(n_new))
    return SLSTMCache(c=c_new, n=n_new, m=m_new, h=h_new)


def slstm_apply(p: dict, x: torch.Tensor, cfg: ArchConfig, *, mode: str = "train",
                cache: Optional[SLSTMCache] = None
                ) -> tuple[torch.Tensor, Optional[SLSTMCache]]:
    """One sLSTM layer on x (B, S, D): a loop over S in place of the
    reference's ``lax.scan``."""
    bsz, s, d = x.shape
    h = cfg.num_heads
    mm = _routed(cfg, x)
    wx = mm(rms_norm(x, p["ln"]), p["w_gates"]).reshape(bsz, s, h, 4 * (d // h))
    st = cache if cache is not None else init_slstm_cache(cfg, bsz, device=x.device)
    hs = []
    for t in range(s):
        st = _slstm_cell(wx[:, t], p["r_gates"], st)
        hs.append(st.h)
    hs = torch.stack(hs, dim=1).reshape(bsz, s, d).to(x.dtype)
    out = x + mm(rms_norm(hs, p["gnorm"]), p["w_down"])
    return out, (st if mode != "train" else None)


def init_slstm_cache(cfg: ArchConfig, batch: int, *, device) -> SLSTMCache:
    h = cfg.num_heads
    shape = (batch, h, cfg.d_model // h)
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    return SLSTMCache(c=z, n=z.clone(), m=torch.full(shape, -1e30, dtype=torch.float32,
                                                     device=device), h=z.clone())
