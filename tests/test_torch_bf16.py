"""The LM at its registered compute dtype: bf16 activations on f32 weights,
against the JAX package on the CPU.

Covered: the plain engine twins (``mm_fused``, ``vpe_mm``) on bf16 x against
the Pallas kernels in interpret mode; ``router.matmul``'s ``out_dtype``;
``_embed_input`` (the reference's f32 promotion under ``embed_scale``);
``prefill``/``decode_step``/``forward`` of reduced qwen3-0.6b and gemma3-1b
in bf16 compute; the serving scenarios of ``test_torch_lm.py`` in bf16 for
qwen3; what ``check_supported`` admits and refuses.

The JAX side is compiled with ``xla_allow_excess_precision`` off.  XLA's
default lets a jitted computation skip the bf16 rounding of an ``astype``
inside a fusion, so the jitted reference is not the function its source
writes: on reduced qwen3 its prefill logits move by 1.09e-2 of max|logit|
with the option on, and agree with the port (and with the reference run
eagerly, ``jax.disable_jit``) within 1.2e-7 with it off.  The port rounds
wherever the reference's source does.

Tolerances (none widened after a comparison ran):

* Engine twins against Pallas, on the same bf16 x and f32 w.  f32 out: rtol
  1e-5, atol 1e-5 * max|ref| (only the order of the f32 sums and the
  activation's exp/tanh differ).  bf16 out: at most one bf16 step of the
  reference value, ``bf16_step(ref)`` (2^-7 of it at the bottom of a binade,
  2^-8 at the top), plus atol 1e-6 * max|ref| for values near 0: both sides
  round an f32 value once, and those values differ only where the f32 sums
  or the activation differ, which can move one across a rounding boundary.
  The share of elements that differ is reported (``record_property``).
* LM logits, bf16 stack (qwen3): ``BF16_LOGIT_TOL`` = 1e-4 of max|logit|,
  set between two readings of this file's model test on reduced qwen3
  (both policies), which records them (``record_property``): the port
  against the reference, at most 1.2e-7 (prefill, decode, forward); and the
  control, the port in f32 compute, which skips every bf16 rounding
  (1.06e-2 and 1.10e-2 on the forward; the jitted reference with excess
  precision on moves as far, above).  The test fails if the control comes
  within the limit.
* LM logits, f32 stack (gemma3: ``embed_scale`` promotes the bf16 embedding
  to f32, so only the embedding's rounding is bf16, the same on both sides):
  the f32 tolerances of ``test_torch_lm.py``, rtol 1e-5, and 2e-3 of
  max|logit| for decode from each side's own bf16 KV cache.
* Engine scenarios: the reference engine's tokens, except where the
  reference's top two logits at the first token that differs are closer
  than ``TIE_GAP`` = 2 * ``BF16_LOGIT_TOL`` of max|logit| (logits that each
  move by at most the limit can swap only so close a pair); such near ties
  are counted and reported.
"""
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced_config
from repro.core import router as jrouter
from repro.kernels.arype_matmul import arype_matmul as j_arype_matmul
from repro.kernels.vpe_smallmm import vpe_matmul as j_vpe_matmul
from repro.models import LM as JLM
from repro.models import transformer as jtransformer
from repro.runtime import RuntimeConfig as JRuntimeConfig
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import router
from repro_torch.kernels.arype_matmul.ops import (
    arype_matmul,
    arype_matmul_unfused,
    mm_fused,
    mm_unfused_partials,
)
from repro_torch.kernels.vpe_smallmm.ops import vpe_matmul, vpe_mm, vpe_mm_q
from repro_torch.models import transformer
from repro_torch.models.transformer import LM
from repro_torch.runtime import RuntimeConfig
from repro_torch.runtime.quant import QuantScales
from repro_torch.serving import Request, ServeConfig, ServeEngine

ACTS = ["none", "relu", "silu", "gelu"]
DTYPE_PAIR = (torch.float32, torch.bfloat16)  # each of x, w and out
F32_RTOL = 1e-5
OWN_CACHE_TOL = 2e-3  # test_torch_lm.py's, for the f32 stack
EXACT = {"xla_allow_excess_precision": False}


def exact_jit(fn, **kw):
    """``jax.jit`` with every ``astype`` of the source rounding (see above)."""
    return jax.jit(fn, compiler_options=EXACT, **kw)


BF16_LOGIT_TOL = 1e-4  # share of max|logit|, bf16 stack (see above)
TIE_GAP = 2 * BF16_LOGIT_TOL


def bf16_step(v: np.ndarray) -> np.ndarray:
    """One bf16 step (ulp) at each |v|: 2^(e - 7) for |v| in [2^e, 2^(e+1))."""
    e = np.floor(np.log2(np.maximum(np.abs(v), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def bf16_pair(rng, shape):
    """One bf16 array of standard normals, as a JAX array and a torch tensor."""
    a = jnp.asarray(rng.standard_normal(shape).astype(np.float32), jnp.bfloat16)
    return a, torch.from_numpy(np.asarray(a.astype(jnp.float32))).bfloat16()


def assert_engine_close(got: torch.Tensor, want, out_dtype, record_property):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    top = float(np.abs(want).max())
    if out_dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=F32_RTOL * top)
        return
    diff = np.abs(got - want)
    assert (diff <= bf16_step(want) + 1e-6 * top).all(), \
        f"max diff {diff.max()} over one bf16 step"
    record_property("share_differing", float((diff > 0).mean()))


# ---------------------------------------------------------------- engine twins


# ragged M/N/K across the Pallas blocks (odd K 301, 129, 5), the decode row
# count of 4 slots, and the skinny/tf32x3 boundary's rows 8 and 9
ENGINE_SHAPES = [(37, 301, 163), (130, 129, 65), (4, 64, 48), (9, 5, 7), (8, 128, 130)]
OUT_DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "f32": (torch.float32, jnp.float32)}


@pytest.mark.parametrize("m,k,n", ENGINE_SHAPES)
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("out", list(OUT_DTYPES))
def test_plain_arype_matmul_on_bf16_matches_pallas(m, k, n, act, out, record_property):
    rng = np.random.default_rng(m * 7 + k * 3 + n)
    xj, xt = bf16_pair(rng, (m, k))
    w = rng.standard_normal((k, n)).astype(np.float32)
    tdt, jdt = OUT_DTYPES[out]
    want = j_arype_matmul(xj, jnp.asarray(w), activation=act, out_dtype=jdt, interpret=True)
    got = arype_matmul(xt, torch.from_numpy(w), activation=act, out_dtype=tdt)
    assert got.dtype == tdt and want.dtype == jdt
    assert_engine_close(got, want, tdt, record_property)
    # the twin is the f32 function of x.float(), rounded once
    assert torch.equal(got, mm_fused(xt.float(), torch.from_numpy(w), activation=act).to(tdt))


@pytest.mark.parametrize("m,k,n", [(1, 64, 48), (7, 16, 8), (33, 1, 2)])
@pytest.mark.parametrize("act", ["none", "silu"])
@pytest.mark.parametrize("out", list(OUT_DTYPES))
def test_plain_vpe_matmul_on_bf16_matches_pallas(m, k, n, act, out, record_property):
    rng = np.random.default_rng(m * 5 + k + n)
    xj, xt = bf16_pair(rng, (m, k))
    w = rng.standard_normal((k, n)).astype(np.float32)
    tdt, jdt = OUT_DTYPES[out]
    want = j_vpe_matmul(xj, jnp.asarray(w), activation=act, out_dtype=jdt, interpret=True)
    got = vpe_matmul(xt, torch.from_numpy(w), activation=act, out_dtype=tdt)
    assert got.dtype == tdt
    assert_engine_close(got, want, tdt, record_property)
    assert torch.equal(got, vpe_mm(xt.float(), torch.from_numpy(w), activation=act).to(tdt))


def test_engines_refuse_what_they_do_not_run():
    """Both engines run every (x, w, out) pair of f32 and bf16, on any
    device the same check: another type of any of the three is refused."""
    x, w = torch.randn(4, 3), torch.randn(3, 2)
    for engine in (arype_matmul, vpe_matmul):
        for xt, wt, ot in itertools.product(DTYPE_PAIR, repeat=3):
            got = engine(x.to(xt), w.to(wt), out_dtype=ot)
            assert got.dtype == ot
            assert torch.equal(got, engine(x.to(xt).float(), w.to(wt).float()).to(ot))
        for xx, ww, od in ((x.half(), w, None), (x, w.half(), None), (x, w, torch.float16),
                           (x.double(), w, None)):
            with pytest.raises(ValueError, match="float32 or bfloat16"):
                engine(xx, ww, out_dtype=od)
    # the unfused ablation alone stays f32: its other types are not ported
    for xx, ww in ((x.bfloat16(), w), (x, w.bfloat16())):
        with pytest.raises(ValueError, match="ROADMAP Queue 2 item 1"):
            arype_matmul_unfused(xx, ww)
        with pytest.raises(ValueError, match="ROADMAP Queue 2 item 1"):
            mm_unfused_partials(xx, ww, bk=2)


# ---------------------------------------------------------------- router


@pytest.mark.parametrize("policy", ["collaborative", "arype_only"])
def test_router_output_dtype_follows_x_and_out_dtype_overrides(policy):
    rng = np.random.default_rng(3)
    xj, xt = bf16_pair(rng, (2, 3, 64))
    w = rng.standard_normal((64, 48)).astype(np.float32)
    wt, cfg = torch.from_numpy(w), RuntimeConfig(policy=policy)
    default = router.matmul(xt, wt, activation="silu", config=cfg)
    wide = router.matmul(xt, wt, activation="silu", out_dtype=torch.float32, config=cfg)
    assert default.dtype == torch.bfloat16 and wide.dtype == torch.float32
    assert default.shape == wide.shape == (2, 3, 48)
    assert torch.equal(default, wide.to(torch.bfloat16))  # one rounding of the same sums
    meta = router.matmul(xt.to("meta"), wt.to("meta"), config=cfg)
    assert meta.dtype == torch.bfloat16 and meta.device.type == "meta"
    meta = router.matmul(xt.to("meta"), wt.to("meta"), out_dtype=torch.float32, config=cfg)
    assert meta.dtype == torch.float32
    # the reference router on both of its arms (jnp dot, Pallas interpret)
    for pallas in (False, True):
        jcfg = JRuntimeConfig(policy=policy, use_pallas=pallas)
        for tdt, jdt, got in ((torch.bfloat16, jnp.bfloat16, default),
                              (torch.float32, jnp.float32, wide)):
            want = jrouter.matmul(xj, jnp.asarray(w), activation="silu", out_dtype=jdt,
                                  config=jcfg)
            assert want.dtype == jdt
            assert_engine_close(got, want, tdt, lambda *a: None)


def test_router_keeps_f32_matmuls_f32():
    """The pipelines pass f32 x: the result stays f32 and does not change."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((256, 96)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((96, 128)).astype(np.float32))
    for policy, engine in (("arype_only", arype_matmul), ("vpe_only", vpe_matmul)):
        got = router.matmul(x, w, activation="relu", config=RuntimeConfig(policy=policy))
        assert got.dtype == torch.float32
        assert torch.equal(got, engine(x, w, activation="relu"))
        assert torch.equal(got, router.matmul(x, w, activation="relu", out_dtype=torch.float32,
                                              config=RuntimeConfig(policy=policy)))


def test_router_refuses_bf16_on_a_quantized_route():
    """A quantized layer now takes bf16 x and ``out_dtype`` as the
    reference passes them (its int8 wrappers' ``out_dtype or x.dtype``): the
    int8 twin of the route's engine, on x's exact f32 values, rounded once.
    What no engine builds (float16) is still refused."""
    table = QuantScales((("fc", 0.05, 0.01),))
    cfg = RuntimeConfig(quantize=True, quant_scales=table)
    x, w = torch.randn(8, 16), torch.randn(16, 4)
    for xt, wt, ot in itertools.product(DTYPE_PAIR, repeat=3):
        got = router.matmul(x.to(xt), w.to(wt), out_dtype=ot, config=cfg, name="fc")
        want = vpe_mm_q(x.to(xt).float(), w.to(wt).float(), scale_x=0.05, scale_w=0.01)
        assert got.dtype == ot and torch.equal(got, want.to(ot))
    assert router.matmul(x.bfloat16(), w, config=cfg, name="fc").dtype == torch.bfloat16
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        router.matmul(x.half(), w, config=cfg, name="fc")
    # a layer without an entry stays on the f32-accumulating engines
    assert router.matmul(x.bfloat16(), w, config=cfg, name="other").dtype == torch.bfloat16


# ---------------------------------------------------------------- the model


ARCHS = ["qwen3-0.6b", "gemma3-1b"]


def test_registered_configs_are_admitted_and_bf16_weights_refused():
    """Every registered config is admitted, bf16 weights included (each
    leaf but the MoE router's in ``param_dtype``); float16 weights or
    compute, which no kernel builds, are refused."""
    for arch in ARCHS:
        cfg = get_config(arch)
        assert (cfg.compute_dtype, cfg.param_dtype) == ("bfloat16", "float32")
        assert LM(cfg, device="cpu").cfg is cfg
        bf = LM(cfg.replace(param_dtype="bfloat16"), device="cpu").abstract_params()
        assert {t.dtype for t in jax.tree.leaves(bf)} == {torch.bfloat16}
        with pytest.raises(NotImplementedError, match="param_dtype"):
            LM(cfg.replace(param_dtype="float16"), device="cpu")
    star = get_config("starcoder2-15b")
    assert (star.compute_dtype, star.param_dtype) == ("bfloat16", "bfloat16")
    assert LM(star, device="cpu").cfg is star
    with pytest.raises(NotImplementedError, match="compute_dtype"):
        LM(get_config("qwen3-0.6b").replace(compute_dtype="float16"), device="cpu")


def _configs(arch: str, policy: str = "collaborative"):
    jcfg = jreduced_config(jget_config(arch)).replace(compute_dtype="bfloat16",
                                                      router_policy=policy)
    cfg = reduced_config(get_config(arch)).replace(compute_dtype="bfloat16",
                                                   router_policy=policy)
    return jcfg, cfg


@pytest.mark.parametrize("arch,dtype", [("qwen3-0.6b", torch.bfloat16),
                                        ("gemma3-1b", torch.float32)])
def test_embed_input_matches_the_reference(arch, dtype):
    jcfg, cfg = _configs(arch)
    jp = to_np(JLM(jcfg).init(jax.random.PRNGKey(2)))
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 7))
    want = jtransformer._embed_input(jp, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)})
    got = transformer._embed_input(convert.lm_params_from_numpy(jp, device="cpu"), cfg,
                                   {"tokens": torch.from_numpy(toks)})
    assert got.dtype == dtype and str(want.dtype) == str(dtype).split(".")[1]
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.fixture(scope="module", params=[("qwen3-0.6b", "collaborative"),
                                        ("qwen3-0.6b", "arype_only"),
                                        ("gemma3-1b", "collaborative")],
                ids=lambda p: "-".join(p))
def models(request):
    """(JAX config with use_pallas, JAX model, its params, port config, port
    model, port params) in bf16 compute; ``arype_only`` puts every matmul
    on ``mm_fused``'s mixed arm, as the full-width serve does."""
    jcfg, cfg = _configs(*request.param)
    jcfg = jcfg.replace(use_pallas=True)
    jm = JLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jcfg, jm, jp, cfg, LM(cfg, device="cpu"), convert.lm_params_from_numpy(
        to_np(jp), device="cpu")


def _dist(got: torch.Tensor, want) -> float:
    """max|got - want| as a share of max|want|."""
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max() / np.abs(want).max())


def _close(got: torch.Tensor, want, tol: float) -> float:
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * np.abs(want).max())
    return _dist(got, want)


def test_prefill_decode_and_forward_match_the_reference(models, record_property):
    jcfg, jm, jp, cfg, m, p = models
    bf16_stack = not cfg.embed_scale
    tol = BF16_LOGIT_TOL if bf16_stack else F32_RTOL
    own = BF16_LOGIT_TOL if bf16_stack else OWN_CACHE_TOL
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 21))  # past gemma3's reduced window of 16
    jtoks = {"tokens": jnp.asarray(toks, jnp.int32)}
    jl, jc = exact_jit(jm.prefill)(jp, jtoks, jm.init_cache(2, 32))
    pl, pc = m.prefill(p, {"tokens": torch.from_numpy(toks)}, m.init_cache(2, 32))
    assert pl.dtype == torch.float32 and pl.shape == (2, 1, cfg.padded_vocab)
    seen = [_close(pl, jl, tol)]
    nxt = np.array(jnp.argmax(jl[:, -1, :cfg.vocab_size], axis=-1))[:, None]
    jl2, _ = exact_jit(jm.decode_step)(jp, {"tokens": jnp.asarray(nxt, jnp.int32)}, jc)
    # from the reference's own cache: identical inputs
    pl2, _ = m.decode_step(p, {"tokens": torch.from_numpy(nxt)},
                           convert.lm_cache_from_numpy(to_np(jc), device="cpu"))
    seen.append(_close(pl2, jl2, tol))
    # from the port's own cache
    pl3, _ = m.decode_step(p, {"tokens": torch.from_numpy(nxt)}, pc)
    seen.append(_close(pl3, jl2, own))
    jf, _ = exact_jit(jm.forward)(jp, jtoks)
    pf, _ = m.forward(p, {"tokens": torch.from_numpy(toks)})
    assert pf.dtype == torch.float32
    seen.append(_close(pf, jf, tol))
    record_property("worst_share_of_max_logit", max(seen))
    if bf16_stack:
        # the control: the same weights in f32 compute lie beyond the limit
        control, _ = LM(cfg.replace(compute_dtype="float32"), device="cpu").forward(
            p, {"tokens": torch.from_numpy(toks)})
        record_property("control_f32_compute", _dist(control, jf))
        assert _dist(control, jf) > tol


def test_hidden_state_dtype_follows_the_reference(models, monkeypatch):
    """qwen3's residual stream stays bf16, gemma3's is f32 after the embed:
    every layer's routed matmuls return the stream's dtype, the head f32."""
    _, _, _, cfg, m, p = models
    seen = []
    real = router.matmul

    def spy(x, w, **kw):
        out = real(x, w, **kw)
        seen.append((x.dtype, out.dtype, kw.get("name")))
        return out

    monkeypatch.setattr(router, "matmul", spy)
    m.forward(p, {"tokens": torch.zeros((1, 5), dtype=torch.int64)})
    stream = torch.float32 if cfg.embed_scale else torch.bfloat16
    *layers, head = seen
    assert len(layers) == 7 * cfg.num_layers
    assert all(x == out == stream for x, out, _ in layers)
    assert head == (stream, torch.float32, "lm_head")


# ---------------------------------------------------------------- serving


@pytest.fixture(scope="module")
def qwen():
    """Reduced qwen3-0.6b in bf16 compute, the JAX engine on its default path
    (exact-rounding jit), with the port's copy of the weights."""
    jcfg, cfg = _configs("qwen3-0.6b")
    jm = JLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jcfg, jm, jp, cfg, convert.lm_params_from_numpy(to_np(jp), device="cpu")


def _exact_engine(jcfg, jp, sc) -> JServeEngine:
    eng = JServeEngine(jcfg, jp, sc)
    eng._prefill = exact_jit(eng.model.prefill)
    eng._decode = exact_jit(eng.model.decode_step, donate_argnums=(2,))
    return eng


@functools.lru_cache(maxsize=None)
def _exact_forward(jm):
    return exact_jit(jm.forward)


def _near_tie(qwen, prompt, ref_tokens, t: int) -> bool:
    """Whether the reference's top two logits for token ``t`` of a request
    (after its prompt and first ``t`` tokens) are closer than ``TIE_GAP``."""
    jcfg, jm, jp, cfg, _ = qwen
    seq = np.concatenate([prompt, np.asarray(ref_tokens[:t], prompt.dtype)])[None]
    logits = np.asarray(_exact_forward(jm)(jp, {"tokens": jnp.asarray(seq, jnp.int32)})[0])
    last = logits[-1, :cfg.vocab_size]
    top2 = np.sort(last)[-2:]
    return top2[1] - top2[0] < TIE_GAP * np.abs(last).max()


def serve_both(qwen, prompts, max_new, record_property, eos_id=-1, **sc):
    """Serve the prompts on the JAX engine and on the port's; each request's
    tokens equal, or differ first at a counted near tie of the reference."""
    jcfg, _, jp, cfg, p = qwen
    jeng = _exact_engine(jcfg, jp, JServeConfig(eos_id=eos_id, **sc))
    eng = ServeEngine(cfg, p, ServeConfig(eos_id=eos_id, **sc), device="cpu")
    out = []
    for engine, req in ((jeng, JRequest), (eng, Request)):
        reqs = [req(rid=i, prompt=pr, max_new=max_new) for i, pr in enumerate(prompts)]
        for r in reqs:
            engine.submit(r)
        done = engine.run_until_drained()
        assert len(done) == len(prompts)
        out.append(reqs)
    jreqs, reqs = out
    ties = 0
    for a, b, prompt in zip(reqs, jreqs, prompts):
        if a.out_tokens != b.out_tokens:
            t = next(i for i, (x, y) in enumerate(zip(a.out_tokens, b.out_tokens)) if x != y)
            assert _near_tie(qwen, prompt, b.out_tokens, t), (a.rid, a.out_tokens, b.out_tokens)
            ties += 1
    record_property("near_ties", ties)
    return eng, reqs, jreqs, ties


def test_engine_more_requests_than_slots_matches_reference_engine(qwen, record_property):
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, qwen[3].vocab_size, 4) for _ in range(5)]
    eng, reqs, _, _ = serve_both(qwen, prompts, 4, record_property, batch_slots=2, cache_len=64)
    assert all(len(r.out_tokens) == 4 for r in reqs)
    assert eng.stats.prefills == 5 and eng.stats.tokens == 20


def test_engine_eos_early_stop_matches_reference_engine(qwen, record_property):
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, qwen[3].vocab_size, 6), rng.integers(0, qwen[3].vocab_size, 4)]
    _, _, jreqs, _ = serve_both(qwen, prompts, 8, record_property, batch_slots=1, cache_len=96)
    ref = jreqs[0].out_tokens
    eos = ref[2]
    _, _, jreqs, _ = serve_both(qwen, prompts, 8, record_property, eos_id=eos, batch_slots=1,
                                cache_len=96)
    early = jreqs[0].out_tokens
    assert early == ref[:ref.index(eos, 1) + 1] and len(early) < 8


def test_engine_reset_reuse_matches_reference_engine(qwen, record_property):
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, qwen[3].vocab_size, 6) for _ in range(3)]
    eng, first, _, _ = serve_both(qwen, prompts, 4, record_property, batch_slots=2,
                                  cache_len=64)
    eng.reset()
    assert eng.queue == [] and eng.slots == [None, None] and not eng.active.any()
    assert int(eng.cache["lengths"].sum()) == 0 and eng.stats.tokens == 0
    again = [Request(rid=i, prompt=p, max_new=4) for i, p in enumerate(prompts)]
    for r in again:
        eng.submit(r)
    eng.run_until_drained()
    assert [r.out_tokens for r in again] == [r.out_tokens for r in first]
