"""The port's recurrent mixers (``models/recurrent.py``: mamba2, mLSTM, sLSTM)
against the JAX package's on the CPU: the scans alone at several chunks
with a padded tail, each mixer's ``*_apply`` in train, prefill and decode
modes with the caches it returns, its gradient, the bf16 compute type, and
the stability checks of ``tests/test_recurrent.py``.  Weights are the
reference's (``init_params`` of its specs), carried over leaf for leaf by
``convert.lm_params_from_numpy``; inputs are made from a numpy seed.

Tolerances.  f32 outputs, states and gradients: rtol 1e-5, atol 1e-5 *
max|ref| (the order of the f32 sums, ``exp`` and ``log1p`` differ from
XLA's).  Against the step-by-step recurrence (float64 numpy): the reference
test's 5e-4 for the mLSTM and 2e-4 for the SSD scan.  bf16 compute: at most
one bf16 step of the reference value plus that atol (an f32 value a last bit
apart can round to the neighbouring bf16 value), and most values equal.
The reference is compiled with ``xla_allow_excess_precision`` off: with it
on, XLA may skip an ``astype``'s rounding inside a fusion
(``tests/test_torch_bf16.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced_config
from repro.models import recurrent as jrec
from repro.models.spec import init_params as jinit_params
from repro_torch import convert
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import recurrent as rec

RTOL = 1e-5
EXACT = {"xla_allow_excess_precision": False}
MIXERS = {"mamba2": "zamba2-2.7b", "mlstm": "xlstm-1.3b", "slstm": "xlstm-1.3b"}


@pytest.fixture(autouse=True)
def one_thread():
    """Thousands of small eager ops: one intra-op thread a test runner
    worker (as ``tests/test_torch_train.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def np32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def close(got, want, rtol: float = RTOL, what: str = "") -> None:
    g, w = np32(got), np32(want)
    np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * max(np.abs(w).max(), 1e-30),
                               err_msg=what)


def bf16_step(v: np.ndarray) -> np.ndarray:
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(v), np.finfo(np.float32).tiny))) - 7)


def within_a_bf16_step(got, want, what: str = "") -> float:
    """Each value within one bf16 step of the reference's plus 1e-5 of
    max|ref|; returns the share of values that differ at all."""
    g, w = np32(got), np32(want)
    bad = np.abs(g - w) > bf16_step(w) + RTOL * np.abs(w).max()
    assert not bad.any(), f"{what}: {bad.sum()} values beyond one bf16 step"
    return float((g != w).mean())


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def same_state(got: tuple, want: tuple, what: str, rtol: float = RTOL) -> None:
    """A port state against the reference's: the same NamedTuple type by
    name and fields, each leaf of the same dtype and within ``rtol``."""
    assert type(got).__name__ == type(want).__name__ and got._fields == want._fields, what
    for name, a, b in zip(got._fields, got, want):
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype), (what, name, a.dtype, b.dtype)
        close(a, b, rtol, f"{what}.{name}")


# ---------------------------------------------------------------- the activations


def test_activations_follow_jax():
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32) * 12
    close(rec.softplus(t(x)), jax.nn.softplus(jnp.asarray(x)), 1e-6)
    close(rec.log_sigmoid(t(x)), jax.nn.log_sigmoid(jnp.asarray(x)), 1e-6)
    close(rec.silu(t(x)), jax.nn.silu(jnp.asarray(x)), 1e-6)
    # logaddexp keeps the log1p term past F.softplus's threshold of 20
    big = torch.tensor([15.5], dtype=torch.float64)
    assert rec.softplus(big).item() == pytest.approx(15.5 + np.log1p(np.exp(-15.5)), rel=1e-15)


# ---------------------------------------------------------------- the scans


def ssd_inputs(rng, b=2, s=19, h=3, p=8, n=4):
    xh = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.asarray(jax.nn.softplus(jnp.asarray(rng.standard_normal((b, s, h)), jnp.float32)))
    a = -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    b_in, c_in = (rng.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    state0 = (rng.standard_normal((b, h, n, p)) * 0.5).astype(np.float32)
    return xh, dt, a, b_in, c_in, state0


@pytest.mark.parametrize("s,chunk", [(19, 8), (16, 8), (19, 5), (11, 256), (1, 8)])
def test_ssd_chunked_matches_the_reference(s, chunk):
    """Several chunks with a padded tail (19 over 8 and 5), whole chunks, one
    chunk, one step; from a non-zero incoming state."""
    xh, dt, a, b_in, c_in, state0 = ssd_inputs(np.random.default_rng(s + chunk), s=s)
    jy, jst = jrec._ssd_chunked(*(jnp.asarray(v) for v in (xh, dt, a, b_in, c_in)), chunk,
                                jnp.asarray(state0))
    y, st = rec._ssd_chunked(*(t(v) for v in (xh, dt, a, b_in, c_in)), chunk, t(state0))
    assert y.dtype == st.dtype == torch.float32 and y.shape == xh.shape
    close(y, jy, what="y")
    close(st, jst, what="state")


def test_ssd_chunked_equals_the_step_recurrence():
    """h_t = exp(dt_t a) h_{t-1} + dt_t B_t (x) x_t, y_t = C_t . h_t in float64."""
    xh, dt, a, b_in, c_in, state0 = (v.astype(np.float64) for v in
                                     ssd_inputs(np.random.default_rng(7), s=23))
    y, st = rec._ssd_chunked(*(t(v).float() for v in (xh, dt, a, b_in, c_in)), 5,
                             t(state0).float())
    h, ys = state0, []
    for i in range(xh.shape[1]):
        da = np.exp(dt[:, i] * a[None])
        h = da[:, :, None, None] * h + np.einsum("bh,bn,bhp->bhnp", dt[:, i], b_in[:, i],
                                                 xh[:, i])
        ys.append(np.einsum("bn,bhnp->bhp", c_in[:, i], h))
    np.testing.assert_allclose(np32(y), np.stack(ys, 1), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np32(st), h, rtol=2e-4, atol=2e-4)


def mlstm_inputs(rng, b=2, s=19, h=2, d=8, cached=True):
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))
    ig = (rng.standard_normal((b, s, h)) * 2.0).astype(np.float32)
    lf = np.asarray(jax.nn.log_sigmoid(jnp.asarray(rng.standard_normal((b, s, h)) * 2.0,
                                                   jnp.float32)))
    if cached:  # a state some steps in: a finite stabiliser
        c = (rng.standard_normal((b, h, d, d)) * 0.3).astype(np.float32)
        n = (rng.standard_normal((b, h, d)) * 0.3).astype(np.float32)
        m = rng.standard_normal((b, h)).astype(np.float32)
    else:
        c, n = np.zeros((b, h, d, d), np.float32), np.zeros((b, h, d), np.float32)
        m = np.full((b, h), -1e30, np.float32)
    return (q, k, v, ig, lf), (c, n, m)


@pytest.mark.parametrize("cached", [False, True], ids=["empty", "cached"])
@pytest.mark.parametrize("s,chunk", [(19, 4), (19, 8), (16, 8), (19, 256), (1, 8)])
def test_mlstm_chunk_scan_matches_the_reference(s, chunk, cached):
    """Several chunks with a padded tail (ig -1e9, lf 0 past S), whole
    chunks, one chunk, one step; from the empty state (m = -1e30) and from
    a state some steps in."""
    ins, state = mlstm_inputs(np.random.default_rng(s * chunk), s=s, cached=cached)
    jh, jc = jrec._mlstm_chunk_scan(*(jnp.asarray(v) for v in ins), chunk,
                                    jrec.MLSTMCache(*(jnp.asarray(v) for v in state)))
    h, c = rec._mlstm_chunk_scan(*(t(v) for v in ins), chunk,
                                 rec.MLSTMCache(*(t(v) for v in state)))
    close(h, jh, what="h")
    same_state(c, jc, "cache")


def test_mlstm_chunk_scan_equals_the_step_recurrence():
    """The stabilised recurrence of the xLSTM paper, step by step in float64
    (``tests/test_recurrent.py``), at chunk 4 over 19 steps."""
    (q, k, v, ig, lf), state = mlstm_inputs(np.random.default_rng(1), cached=False)
    b, s, h, d = q.shape
    out, cache = rec._mlstm_chunk_scan(*(t(a) for a in (q, k, v, ig, lf)), 4,
                                       rec.MLSTMCache(*(t(a) for a in state)))
    c, n, m = np.zeros((b, h, d, d)), np.zeros((b, h, d)), np.full((b, h), -1e30)
    qn, kn, vn = q.astype(np.float64) / np.sqrt(d), k.astype(np.float64), v.astype(np.float64)
    hs = []
    for i in range(s):
        m_new = np.maximum(lf[:, i] + m, ig[:, i])
        i_p, f_p = np.exp(ig[:, i] - m_new), np.exp(lf[:, i] + m - m_new)
        c = f_p[:, :, None, None] * c + i_p[:, :, None, None] * np.einsum("bhd,bhp->bhdp",
                                                                           kn[:, i], vn[:, i])
        n = f_p[:, :, None] * n + i_p[:, :, None] * kn[:, i]
        m = m_new
        den = np.maximum(np.abs(np.einsum("bhd,bhd->bh", qn[:, i], n)), np.exp(-m))
        hs.append(np.einsum("bhd,bhdp->bhp", qn[:, i], c) / den[:, :, None])
    np.testing.assert_allclose(np32(out), np.stack(hs, 1), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(np32(cache.m), m, rtol=1e-5)
    # the scan's state is the recurrence's at the same stabiliser
    np.testing.assert_allclose(np32(cache.c), c, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(np32(cache.n), n, rtol=1e-3, atol=1e-3)


def test_causal_conv_promotes_a_bf16_state_like_the_reference():
    """A bf16 state before f32 inputs: the new state comes back f32, as
    ``jnp.concatenate`` promotes it (the conv-state trap); bf16 inputs keep
    it bf16."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 6)).astype(np.float32)
    w = (rng.standard_normal((4, 6)) * 0.3).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    state = rng.standard_normal((2, 3, 6)).astype(np.float32)
    jstate = jnp.asarray(state, jnp.bfloat16)
    for xdt, jxdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        jy, jst = jrec._causal_conv(jnp.asarray(x, jxdt), jnp.asarray(w), jnp.asarray(bias),
                                    jstate)
        y, st = rec._causal_conv(t(np32(jnp.asarray(x, jxdt))).to(xdt), t(w), t(bias),
                                 t(np32(jstate)).bfloat16())
        assert str(st.dtype).removeprefix("torch.") == str(jst.dtype)
        assert str(y.dtype).removeprefix("torch.") == str(jy.dtype)
        np.testing.assert_array_equal(np32(st), np32(jst))
        if xdt == torch.float32:
            close(y, jy)
        else:
            within_a_bf16_step(y, jy, "bf16 conv")


# ---------------------------------------------------------------- the mixers


@pytest.fixture(scope="module", params=list(MIXERS))
def mixer(request):
    """(name, reference config, port config, reference params, port params)
    of one mixer at its reduced arch (mamba2: zamba2's chunk 8, so 19 steps
    run three chunks, the last padded; mLSTM: xlstm's chunk 256, one
    chunk)."""
    name = request.param
    jcfg = jreduced_config(jget_config(MIXERS[name]))
    cfg = reduced_config(get_config(MIXERS[name]))
    jp = jinit_params(getattr(jrec, f"{name}_specs")(jcfg), jax.random.PRNGKey(0))
    return name, jcfg, cfg, jp, convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                                              device="cpu")


def japply(name: str, jcfg, mode: str):
    """The reference's ``*_apply`` in ``mode``, jitted with every rounding."""
    return jax.jit(functools.partial(getattr(jrec, f"{name}_apply"), cfg=jcfg, mode=mode),
                   compiler_options=EXACT)


def _init_cache(name, cfg, b, jax_side: bool):
    if jax_side:
        return getattr(jrec, f"init_{name}_cache")(cfg, b)
    return getattr(rec, f"init_{name}_cache")(cfg, b, device="cpu")


def test_mixer_apply_matches_the_reference_in_every_mode(mixer):
    """train on 19 steps; prefill of 12 steps from the empty cache; 4 decode
    steps, each one token, from the cache before it (the reference's cache,
    so both sides see the same inputs, and the port's own, held the same
    way); every output and returned cache leaf within rtol 1e-5, of the
    reference's type (mamba2's conv state f32 after an f32 step)."""
    name, jcfg, cfg, jp, p = mixer
    apply = getattr(rec, f"{name}_apply")
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((2, 19, cfg.d_model)) * 0.5).astype(np.float32)
    jy, jc = japply(name, jcfg, "train")(jp, jnp.asarray(x))
    y, c = apply(p, t(x), cfg, mode="train")
    assert c is None and jc is None
    close(y, jy, what="train")

    jy, jc = japply(name, jcfg, "prefill")(jp, jnp.asarray(x[:, :12]),
                                           cache=_init_cache(name, jcfg, 2, True))
    y, c = apply(p, t(x[:, :12]), cfg, mode="prefill", cache=_init_cache(name, cfg, 2, False))
    close(y, jy, what="prefill")
    same_state(c, jc, "prefill")
    if name == "mamba2":
        assert c.conv.dtype == torch.float32  # the bf16 buffer promoted by f32 inputs
    jdecode = japply(name, jcfg, "decode")
    for i in range(12, 16):
        jy, jc2 = jdecode(jp, jnp.asarray(x[:, i:i + 1]), cache=jc)
        y, _ = apply(p, t(x[:, i:i + 1]), cfg, mode="decode",
                     cache=type(c)(*(t(np.asarray(v)) for v in jc)))
        close(y, jy, what=f"decode {i} from the reference's cache")
        y, c = apply(p, t(x[:, i:i + 1]), cfg, mode="decode", cache=c)
        close(y, jy, what=f"decode {i} from the port's cache")
        same_state(c, jc2, f"decode {i}")
        jc = jc2


def test_mixer_gradients_match_jax_vjp(mixer):
    """The port's autograd through ``*_apply`` in training (the routed
    matmuls through ``router.EngineMatmul``) against ``jax.vjp`` of the
    reference's: d(x) and every parameter's gradient within rtol 1e-5."""
    name, jcfg, cfg, jp, p = mixer
    rng = np.random.default_rng(12)
    x = (rng.standard_normal((2, 13, cfg.d_model)) * 0.5).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)

    def f(params, xx):
        return getattr(jrec, f"{name}_apply")(params, xx, jcfg, mode="train")[0]

    jy, (jdp, jdx) = jax.jit(lambda a, b, g: (f(a, b), jax.vjp(f, a, b)[1](g)))(
        jp, jnp.asarray(x), jnp.asarray(ct))
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    xt = t(x).requires_grad_()
    y, _ = getattr(rec, f"{name}_apply")(leaves, xt, cfg, mode="train")
    y.backward(t(ct))
    close(y, jy, what="y")
    close(xt.grad, jdx, what="dx")
    for k, v in leaves.items():
        close(v.grad, jdp[k], what=f"d{k}")


def test_mixer_in_bf16_compute_matches_the_reference(mixer):
    """bf16 activations on f32 weights (the registered compute type): the
    output and the returned state within one bf16 step (bf16 leaves) or rtol
    1e-5 (f32 leaves) of the eager reference's, types equal; most bf16
    values equal.  mamba2's conv state stays bf16."""
    name, jcfg, cfg, jp, p = mixer
    jcfg, cfg = jcfg.replace(compute_dtype="bfloat16"), cfg.replace(compute_dtype="bfloat16")
    rng = np.random.default_rng(13)
    x = jnp.asarray(rng.standard_normal((2, 11, cfg.d_model)) * 0.5, jnp.bfloat16)
    jy, jc = japply(name, jcfg, "prefill")(jp, x, cache=_init_cache(name, jcfg, 2, True))
    y, c = getattr(rec, f"{name}_apply")(p, t(np32(x)).bfloat16(), cfg, mode="prefill",
                                         cache=_init_cache(name, cfg, 2, False))
    assert y.dtype == torch.bfloat16
    assert within_a_bf16_step(y, jy, "bf16 out") < 0.05
    assert type(c).__name__ == type(jc).__name__
    for field, a, b in zip(c._fields, c, jc):
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype), field
        if a.dtype == torch.bfloat16:
            within_a_bf16_step(a, b, field)
        else:  # f32 state from bf16 inputs: a flipped bf16 rounding upstream moves it
            np.testing.assert_allclose(np32(a), np32(b), rtol=2**-7,
                                       atol=2**-7 * np.abs(np32(b)).max(), err_msg=field)


# ---------------------------------------------------------------- stability (tests/test_recurrent.py)


def test_mamba2_decode_continues_the_chunked_prefill():
    cfg = reduced_config(get_config("zamba2-2.7b"))
    from repro_torch.models.spec import init_params

    p = init_params(rec.mamba2_specs(cfg), torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn(2, 11, cfg.d_model, generator=torch.Generator().manual_seed(1)) * 0.3
    y_full, c_full = rec.mamba2_apply(p, x, cfg, mode="prefill",
                                      cache=rec.init_mamba2_cache(cfg, 2, device="cpu"))
    _, c = rec.mamba2_apply(p, x[:, :10], cfg, mode="prefill",
                            cache=rec.init_mamba2_cache(cfg, 2, device="cpu"))
    y_dec, c = rec.mamba2_apply(p, x[:, 10:], cfg, mode="decode", cache=c)
    close(y_dec[:, 0], y_full[:, -1], 2e-5)
    close(c.ssm, c_full.ssm, 2e-5)
    close(c.conv, c_full.conv, 0)


def test_slstm_stays_finite_over_a_long_sequence():
    cfg = reduced_config(get_config("xlstm-1.3b"))
    from repro_torch.models.spec import init_params

    p = init_params(rec.slstm_specs(cfg), torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn(1, 200, cfg.d_model, generator=torch.Generator().manual_seed(1)) * 3.0
    y, c = rec.slstm_apply(p, x, cfg, mode="prefill")
    assert torch.isfinite(y).all() and all(torch.isfinite(leaf).all() for leaf in c)


def test_mlstm_gate_extremes_stay_finite():
    cfg = reduced_config(get_config("xlstm-1.3b"))
    from repro_torch.models.spec import init_params

    p = init_params(rec.mlstm_specs(cfg), torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn(1, 64, cfg.d_model, generator=torch.Generator().manual_seed(1)) * 10.0
    y, _ = rec.mlstm_apply(p, x, cfg, mode="train")
    assert torch.isfinite(y).all()
