"""bf16 weights (``param_dtype="bfloat16"``) in the port, against the JAX
package on the CPU.

Covered: the plain engine twins (``mm_fused``, ``vpe_mm``) in every (x, w,
out) pair of f32 and bf16 against the Pallas kernels in interpret mode; the
int8 twins (``vpe_mm_q``, ``mm_fused_q``) on bf16 x and w into bf16 and f32
against the reference's int8 wrappers; the MoE layer on bf16 experts;
starcoder2-15b and qwen3-4b (configs, specs, and their reduced models:
starcoder2 on bf16 weights in f32 and bf16 compute, qwen3-0.6b on bf16
weights in bf16 compute, qwen3-4b in f32) and the serving scenarios of
``test_torch_bf16.py`` on reduced starcoder2.

Tolerances are ``test_torch_bf16.py``'s and ``test_torch_lm.py``'s (none
widened after a comparison ran):

* Engine twins against Pallas on the same operands: f32 out rtol 1e-5, atol
  1e-5 * max|ref|; bf16 out one bf16 step of the reference value plus atol
  1e-6 * max|ref| (both sides sum exact products in f32 in another order and
  round once).
* Int8 twins: f32 out bit for bit (the int32 sums are exact, and a bf16
  element is quantized as its exact f32 on both sides), bf16 out within one
  bf16 step (the same f32 value rounded once on each side).  The reference
  runs eagerly (``jax.disable_jit``): jitted, XLA turns its quantizers'
  division by a constant scale into a multiply by the reciprocal, which
  moves some codes (ROADMAP Queue 3, reference caveats).
* The MoE layer, bf16 experts: two bf16 steps plus atol 1e-6 * max|ref|, as
  ``test_torch_moe.py`` holds bf16 compute on f32 experts.
* LM logits on f32 compute (reduced starcoder2 on bf16 weights, reduced
  qwen3-4b): rtol 1e-5, and 2e-3 of max|logit| for decode from each side's
  own bf16 KV cache.
* LM logits on bf16 compute and bf16 weights: reduced qwen3-0.6b within
  ``BF16_LOGIT_TOL`` = 1e-4 of max|logit|, with the f32-compute control (the
  same weights, f32 activations) required outside it.  Reduced starcoder2:
  each layer on the reference's own inputs, its outputs equal but at under
  ``LAYER_FLIP_SHARE`` of them (each one bf16 step apart, the port's value
  there the exact sum rounded once), the control required above that
  share; its logits are recorded and held below the control's distance
  (see the tests: one flipped rounding moves them by some 3e-3 of
  max|logit|).  The reference is compiled with ``xla_allow_excess_precision``
  off.
"""
import dataclasses
import itertools
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced_config
from repro.kernels.arype_matmul import arype_matmul as j_arype_matmul
from repro.kernels.arype_matmul import arype_matmul_q as j_arype_matmul_q
from repro.kernels.vpe_smallmm import vpe_matmul as j_vpe_matmul
from repro.kernels.vpe_smallmm import vpe_matmul_q as j_vpe_matmul_q
from repro.models import LM as JLM
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.models.spec import init_params as jinit_params
from repro_torch import convert
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import router
from repro_torch.kernels.arype_matmul.ops import arype_matmul, arype_matmul_q, mm_fused
from repro_torch.kernels.vpe_smallmm.ops import vpe_matmul, vpe_matmul_q, vpe_mm
from repro_torch.models import layers, spec
from repro_torch.models.transformer import LM, model_specs
from test_torch_bf16 import (
    BF16_LOGIT_TOL,
    EXACT,
    F32_RTOL,
    OWN_CACHE_TOL,
    _close,
    _dist,
    assert_engine_close,
    bf16_step,
    exact_jit,
    serve_both,
    to_np,
)

ACTS = ["none", "relu", "silu", "gelu"]
TYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
TRIPLES = list(itertools.product(TYPES, repeat=3))  # (x, w, out)
TRIPLE_IDS = ["-".join(t) for t in TRIPLES]
NEW_ARCHS = ["starcoder2-15b", "qwen3-4b"]


def pair(rng, shape, dtype: str, scale: float = 1.0):
    """One array of normals in ``dtype``, as a JAX array and a torch tensor
    holding the same values."""
    a = jnp.asarray((rng.standard_normal(shape) * scale).astype(np.float32), TYPES[dtype][1])
    return a, torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(TYPES[dtype][0])


# ---------------------------------------------------------------- engine twins


@pytest.mark.parametrize("x,w,out", TRIPLES, ids=TRIPLE_IDS)
@pytest.mark.parametrize("act", ACTS)
def test_plain_arype_matmul_on_every_dtype_pair_matches_pallas(x, w, out, act,
                                                               record_property):
    """Ragged M/N/K across the Pallas blocks (K 301 is odd)."""
    rng = np.random.default_rng(37 + ACTS.index(act))
    xj, xt = pair(rng, (37, 301), x)
    wj, wt = pair(rng, (301, 163), w)
    tdt, jdt = TYPES[out]
    want = j_arype_matmul(xj, wj, activation=act, out_dtype=jdt, interpret=True)
    got = arype_matmul(xt, wt, activation=act, out_dtype=tdt)
    assert got.dtype == tdt and want.dtype == jdt
    assert_engine_close(got, want, tdt, record_property)
    # the twin is the f32 function of the upcast operands, rounded once
    assert torch.equal(got, mm_fused(xt.float(), wt.float(), activation=act).to(tdt))


@pytest.mark.parametrize("x,w,out", TRIPLES, ids=TRIPLE_IDS)
def test_plain_engines_on_every_dtype_pair_match_pallas_at_few_rows(x, w, out,
                                                                    record_property):
    """The decode rows of 4 slots on the AryPE and a batch-1 projection on
    the VPE, under gelu (the starcoder2 MLP's activation)."""
    rng = np.random.default_rng(4)
    tdt, jdt = TYPES[out]
    for ours, theirs, (m, k, n) in ((arype_matmul, j_arype_matmul, (4, 64, 48)),
                                    (vpe_matmul, j_vpe_matmul, (1, 16, 8)),
                                    (vpe_matmul, j_vpe_matmul, (7, 16, 8))):
        xj, xt = pair(rng, (m, k), x)
        wj, wt = pair(rng, (k, n), w)
        want = theirs(xj, wj, activation="gelu", out_dtype=jdt, interpret=True)
        got = ours(xt, wt, activation="gelu", out_dtype=tdt)
        assert got.dtype == tdt
        assert_engine_close(got, want, tdt, record_property)
    assert torch.equal(got, vpe_mm(xt.float(), wt.float(), activation="gelu").to(tdt))


@pytest.mark.parametrize("engine", ["vpe", "arype"])
@pytest.mark.parametrize("w", list(TYPES))
def test_int8_twins_on_bf16_x_match_the_reference(engine, w):
    """bf16 x (and w f32 or bf16) on the int8 engines, into f32 (the int32
    sums pinned: bit for bit) and, after a relu, bf16 (one rounding of the
    same value)."""
    ours, theirs = {"vpe": (vpe_matmul_q, j_vpe_matmul_q),
                    "arype": (arype_matmul_q, j_arype_matmul_q)}[engine]
    rng = np.random.default_rng(11)
    m, k, n = (40, 12, 6) if engine == "vpe" else (37, 96, 65)
    xj, xt = pair(rng, (m, k), "bf16", scale=3.0)
    wj, wt = pair(rng, (k, n), w)
    sx = float(np.abs(np.asarray(xj.astype(jnp.float32))).max()) / 127
    sw = tuple(float(v) / 127 for v in np.abs(np.asarray(wj.astype(jnp.float32))).max(0))
    for act, out in (("none", TYPES["f32"]), ("relu", TYPES["bf16"])):
        with jax.disable_jit():
            want = theirs(xj, wj, scale_x=sx, scale_w=sw, activation=act, out_dtype=out[1],
                          interpret=True)
        got = ours(xt, wt, scale_x=sx, scale_w=sw, activation=act, out_dtype=out[0])
        assert got.dtype == out[0] and want.dtype == out[1]
        want = np.asarray(want.astype(jnp.float32))
        if out[0] == torch.float32:
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            diff = np.abs(got.float().numpy() - want)
            assert (diff <= bf16_step(want)).all(), diff.max()
    # the default output is x's type, as the reference's out_dtype or x.dtype
    assert ours(xt, wt, scale_x=sx, scale_w=sw).dtype == torch.bfloat16


# ---------------------------------------------------------------- the MoE layer


@pytest.mark.parametrize("groups", [1, 2])
def test_moe_apply_on_bf16_experts_matches_the_reference(groups, record_property):
    """Reduced granite with bf16 experts and bf16 compute: every expert
    product is bf16 x bf16 in the reference, so it rounds to bf16 there."""
    kw = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg = jreduced_config(jget_config("granite-moe-1b-a400m")).replace(**kw)
    cfg = reduced_config(get_config("granite-moe-1b-a400m")).replace(**kw)
    jp = jinit_params(jlayers.moe_specs(jcfg), jax.random.PRNGKey(0))
    p = convert.lm_params_from_numpy(to_np(jp), device="cpu")
    assert p["w_gate"].dtype == torch.bfloat16 and p["router"].dtype == torch.float32
    x = jnp.asarray(np.asarray(jax.random.normal(jax.random.PRNGKey(5), (2, 12, cfg.d_model))),
                    jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).bfloat16()
    jout, jaux = jax.jit(lambda p, x: jlayers.moe_apply(p, x, jcfg, num_groups=groups),
                         compiler_options=EXACT)(jp, x)
    out, aux = layers.moe_apply(p, xt, cfg, num_groups=groups)
    assert out.dtype == torch.bfloat16
    want = np.asarray(jout.astype(jnp.float32))
    diff = np.abs(out.float().numpy() - want)
    assert (diff <= 2 * bf16_step(want) + 1e-6 * np.abs(want).max()).all(), diff.max()
    record_property("share_differing", float((diff > 0).mean()))
    assert abs(float(aux) - float(jaux)) <= 1e-6


# ---------------------------------------------------------------- configs


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_configs_and_specs_equal_the_references(arch):
    for port, ref in ((get_config(arch), jget_config(arch)),
                      (reduced_config(get_config(arch)), jreduced_config(jget_config(arch)))):
        for f in dataclasses.fields(port):
            got, want = getattr(port, f.name), getattr(ref, f.name)
            if f.name.endswith("_pattern"):
                got, want = [(s.mixer, s.ffn) for s in got], [(s.mixer, s.ffn) for s in want]
            assert got == want, f.name
        ref_specs = jax.tree.map(lambda s: (s.shape, s.init, s.dtype),
                                 jtransformer.model_specs(ref),
                                 is_leaf=lambda x: hasattr(x, "init"))
        assert spec.map_specs(lambda s: (s.shape, s.init, s.dtype), model_specs(port)) == ref_specs
    full = LM(get_config(arch), device="cpu").abstract_params()
    n = sum(t.numel() for t in jax.tree.leaves(full))
    nbytes = sum(t.numel() * t.element_size() for t in jax.tree.leaves(full))
    # both fit one 80 GB card: starcoder2 in bf16, qwen3-4b in f32
    assert (n, nbytes) == {"starcoder2-15b": (15955630080, 31911260160),
                           "qwen3-4b": (4411424256, 17645697024)}[arch]


# ---------------------------------------------------------------- the models


def _star_configs(policy: str = "collaborative", compute: str = "bfloat16"):
    kw = dict(param_dtype="bfloat16", compute_dtype=compute, router_policy=policy)
    return (jreduced_config(jget_config("starcoder2-15b")).replace(**kw),
            reduced_config(get_config("starcoder2-15b")).replace(**kw))


@pytest.fixture(scope="module", params=["collaborative", "arype_only"])
def starcoder(request):
    """(JAX model with use_pallas, its bf16 params, JAX config, port config,
    port params): reduced starcoder2-15b in bf16 weights and compute;
    ``arype_only`` puts every matmul on ``mm_fused``'s bf16 x bf16 arm, as
    the full-width serve does."""
    jcfg, cfg = _star_configs(request.param)
    jcfg = jcfg.replace(use_pallas=True)
    jm = JLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, jcfg, cfg, convert.lm_params_from_numpy(to_np(jp), device="cpu")


def _logit_readings(jm, jp, cfg, p, toks, *, exact: bool) -> dict:
    """The port's prefill, decode (from the reference's cache and from its
    own) and forward logits, each as a share of max|logit| from the
    reference's (compiled with ``xla_allow_excess_precision`` off where
    ``exact``)."""
    jit = exact_jit if exact else jax.jit
    m = LM(cfg, device="cpu")
    jtoks = {"tokens": jnp.asarray(toks, jnp.int32)}
    jl, jc = jit(jm.prefill)(jp, jtoks, jm.init_cache(2, 32))
    pl, pc = m.prefill(p, {"tokens": torch.from_numpy(toks)}, m.init_cache(2, 32))
    assert pl.dtype == torch.float32 and pl.shape == (2, 1, cfg.padded_vocab)
    nxt = np.array(jnp.argmax(jl[:, -1, :cfg.vocab_size], axis=-1))[:, None]
    jl2, _ = jit(jm.decode_step)(jp, {"tokens": jnp.asarray(nxt, jnp.int32)}, jc)
    pl2, _ = m.decode_step(p, {"tokens": torch.from_numpy(nxt)},
                           convert.lm_cache_from_numpy(to_np(jc), device="cpu"))
    pl3, _ = m.decode_step(p, {"tokens": torch.from_numpy(nxt)}, pc)
    jf, _ = jit(jm.forward)(jp, jtoks)
    pf, _ = m.forward(p, {"tokens": torch.from_numpy(toks)})
    return {"prefill": (pl, jl), "decode": (pl2, jl2), "own cache": (pl3, jl2),
            "forward": (pf, jf)}


def test_starcoder2_bf16_prefill_decode_and_forward_match_the_reference(starcoder,
                                                                        record_property):
    """bf16 weights in both compute types.  f32 compute (the engines' f32 x
    on bf16 w arm, no bf16 rounding but the KV cache): every logit within
    the f32 tolerances.  bf16 compute: the readings are recorded and lie
    below the f32-compute control's; the rounding of each layer is held on
    the reference's own layer inputs below (one bf16 rounding that the two
    sides' f32 sums put on either side of a tie, at 2 of 2688 outputs of
    one layer, where the port's value is the correctly rounded one, moves
    these logits by 3.0e-3 of max|logit|, and no limit at this depth
    separates that from the control's 8.3e-3)."""
    jm, jp, jcfg, cfg, p = starcoder
    assert {t.dtype for t in jax.tree.leaves(p)} == {torch.bfloat16}
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 21))
    f32 = JLM(jcfg.replace(compute_dtype="float32"))
    for name, (got, want) in _logit_readings(f32, jp, cfg.replace(compute_dtype="float32"), p,
                                             toks, exact=False).items():
        _close(got, want, OWN_CACHE_TOL if name == "own cache" else F32_RTOL)
    seen = {name: _dist(got, want)
            for name, (got, want) in _logit_readings(jm, jp, cfg, p, toks, exact=True).items()}
    record_property("bf16_compute_share_of_max_logit", seen)
    jf, _ = exact_jit(jm.forward)(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    control, _ = LM(cfg.replace(compute_dtype="float32"), device="cpu").forward(
        p, {"tokens": torch.from_numpy(toks)})
    record_property("control_f32_compute", _dist(control, jf))
    assert max(seen.values()) < _dist(control, jf)


# A layer's bf16 outputs, port against reference on the reference's own input:
# equal but where the two sides' f32 sums put a value on either side of a
# bf16 rounding tie, one step apart (readings: 2 of 2688 outputs of one
# layer, 0 elsewhere; products of bf16 operands are exact and their sums
# often land on a tie).  The f32-compute control differs at 40-65% of them.
LAYER_FLIP_SHARE = 0.01


def round_bf16(v: Fraction) -> float:
    """The exact value ``v`` rounded to the nearest bf16, ties to even."""
    near = torch.tensor(float(v)).bfloat16()
    steps = torch.tensor([-np.inf, np.inf], dtype=torch.bfloat16)
    cands = [near, torch.nextafter(near, steps[0]), torch.nextafter(near, steps[1])]
    # bf16 is the top half of an f32, so an even bf16 has bit 16 of its f32 clear
    return min((abs(Fraction(float(c)) - v), int(c.float().view(torch.int32)) >> 16 & 1,
                float(c)) for c in cands)[2]


def assert_flips_correctly_rounded(got, want, x, last) -> int:
    """Where the port's layer output ``got`` differs from the reference's
    ``want``, the port holds ``x + round(sum)``: the residual ``x`` plus the
    exact sum of the bf16 products of the layer's last matmul (``last``:
    its operands as the port fed them), rounded once to bf16.  Returns the
    number of outputs checked."""
    a, w = last
    a = a.reshape(-1, a.shape[-1]).double().numpy()
    w = w.double().numpy()
    flat, res = got.reshape(-1, got.shape[-1]), x.reshape(-1, x.shape[-1])
    rows, cols = np.nonzero(flat.float().numpy() != want.reshape(flat.shape))
    for r, c in zip(rows, cols):
        exact = sum((Fraction(float(u)) * Fraction(float(v)) for u, v in zip(a[r], w[:, c])),
                    Fraction(0))
        o = torch.tensor(round_bf16(exact)).bfloat16()
        assert flat[r, c] == res[r, c] + o, (r, c, float(flat[r, c]), float(exact))
    return len(rows)


def test_starcoder2_bf16_layers_match_the_reference_on_its_inputs(starcoder, record_property,
                                                                  monkeypatch):
    """Each layer of reduced starcoder2 in bf16 (the attention, then the
    plain gelu MLP, every superblock), fed the reference's own output of the
    layer before: its outputs equal the reference's but at under
    ``LAYER_FLIP_SHARE`` of them, each within one bf16 step, and there the
    port's value is the correctly rounded one (``assert_flips_correctly_
    rounded``); the f32-compute control on the same inputs differs at more
    than that share."""
    _, jp, jcfg, cfg, p = starcoder
    calls = []
    matmul = router.matmul

    def spy(x, w, **kw):
        calls.append((x, w))
        return matmul(x, w, **kw)

    monkeypatch.setattr(router, "matmul", spy)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 21))
    h = jtransformer._embed_input(jp, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)})
    f32 = cfg.replace(compute_dtype="float32")
    apply = {"mixer": (lambda q, x, c: jlayers.attn_apply(q, x, c, kind="causal")[0],
                       lambda q, x, c: layers.attn_apply(q, x, c, kind="causal")[0]),
             "ffn": (lambda q, x, c: jlayers.mlp_apply(q, x, c),
                     lambda q, x, c: layers.mlp_apply(q, x, c))}
    shares, flips = [], 0
    for sb in range(cfg.num_superblocks):
        for part in ("mixer", "ffn"):
            ref_fn, port_fn = apply[part]
            jq = jax.tree.map(lambda a: a[sb], jp["blocks"]["l0"][part])
            q = {name: leaf[sb] for name, leaf in p["blocks"]["l0"][part].items()}
            x = torch.from_numpy(np.asarray(h.astype(jnp.float32))).bfloat16()
            h = exact_jit(lambda q, x: ref_fn(q, x, jcfg))(jq, h)
            want = np.asarray(h.astype(jnp.float32))
            got = port_fn(q, x, cfg)
            assert got.dtype == torch.bfloat16
            diff = np.abs(got.float().numpy() - want)
            assert (diff <= bf16_step(want) + 1e-6 * np.abs(want).max()).all(), (sb, part)
            shares.append(float((diff > 0).mean()))
            assert shares[-1] < LAYER_FLIP_SHARE, (sb, part, shares[-1])
            flips += assert_flips_correctly_rounded(got, want, x, calls[-1])
            control = port_fn(q, x.float(), f32).to(torch.bfloat16).float().numpy()
            assert float((control != want).mean()) > LAYER_FLIP_SHARE, (sb, part)
    record_property("share_differing_per_layer", shares)
    record_property("differing_outputs_checked", flips)


@pytest.mark.parametrize("policy", ["collaborative", "arype_only"])
def test_qwen3_on_bf16_weights_matches_the_reference_in_bf16(policy, record_property):
    """Reduced qwen3-0.6b on bf16 weights and bf16 compute (its qk-norm and
    gated MLP on bf16 leaves): prefill, decode and forward within
    ``BF16_LOGIT_TOL``, the f32-compute control outside it."""
    kw = dict(param_dtype="bfloat16", compute_dtype="bfloat16", router_policy=policy)
    jcfg = jreduced_config(jget_config("qwen3-0.6b")).replace(use_pallas=True, **kw)
    cfg = reduced_config(get_config("qwen3-0.6b")).replace(**kw)
    jm = JLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    p = convert.lm_params_from_numpy(to_np(jp), device="cpu")
    assert {t.dtype for t in jax.tree.leaves(p)} == {torch.bfloat16}
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 21))
    seen = [_close(got, want, BF16_LOGIT_TOL)
            for got, want in _logit_readings(jm, jp, cfg, p, toks, exact=True).values()]
    record_property("worst_share_of_max_logit", max(seen))
    jf, _ = exact_jit(jm.forward)(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    control, _ = LM(cfg.replace(compute_dtype="float32"), device="cpu").forward(
        p, {"tokens": torch.from_numpy(toks)})
    record_property("control_f32_compute", _dist(control, jf))
    assert _dist(control, jf) > BF16_LOGIT_TOL


@pytest.fixture(scope="module")
def starcoder_engine():
    """Reduced starcoder2-15b in bf16 weights and compute for the serving
    scenarios: ``test_torch_bf16.serve_both``'s (config, model, params,
    port config, port params)."""
    jcfg, cfg = _star_configs()
    jm = JLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jcfg, jm, jp, cfg, convert.lm_params_from_numpy(to_np(jp), device="cpu")


@pytest.mark.parametrize("slots,cache_len,requests,max_new", [(2, 64, 5, 4), (1, 96, 2, 8)],
                         ids=["more-requests-than-slots", "one-slot"])
def test_starcoder2_engine_matches_the_reference_engine(starcoder_engine, slots, cache_len,
                                                        requests, max_new, record_property):
    rng = np.random.default_rng(slots)
    prompts = [rng.integers(0, starcoder_engine[3].vocab_size, 4 + 2 * i)
               for i in range(requests)]
    eng, reqs, _, _ = serve_both(starcoder_engine, prompts, max_new, record_property,
                                 batch_slots=slots, cache_len=cache_len)
    assert all(len(r.out_tokens) == max_new for r in reqs)
    assert eng.stats.prefills == requests and eng.stats.tokens == requests * max_new


def test_qwen3_4b_f32_prefill_decode_and_forward_match_the_reference():
    jcfg = jreduced_config(jget_config("qwen3-4b")).replace(use_pallas=True)
    cfg = reduced_config(get_config("qwen3-4b"))
    assert (cfg.param_dtype, cfg.compute_dtype) == ("float32", "float32")
    jm = JLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m, p = LM(cfg, device="cpu"), convert.lm_params_from_numpy(to_np(jp), device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 21))
    jtoks = {"tokens": jnp.asarray(toks, jnp.int32)}
    jl, jc = jax.jit(jm.prefill)(jp, jtoks, jm.init_cache(2, 32))
    pl, pc = m.prefill(p, {"tokens": torch.from_numpy(toks)}, m.init_cache(2, 32))
    _close(pl, jl, F32_RTOL)
    nxt = np.array(jnp.argmax(jl[:, -1, :cfg.vocab_size], axis=-1))[:, None]
    jl2, _ = jax.jit(jm.decode_step)(jp, {"tokens": jnp.asarray(nxt, jnp.int32)}, jc)
    pl2, _ = m.decode_step(p, {"tokens": torch.from_numpy(nxt)},
                           convert.lm_cache_from_numpy(to_np(jc), device="cpu"))
    _close(pl2, jl2, F32_RTOL)
    pl3, _ = m.decode_step(p, {"tokens": torch.from_numpy(nxt)}, pc)
    _close(pl3, jl2, OWN_CACHE_TOL)
    jf, _ = jax.jit(jm.forward)(jp, jtoks)
    pf, _ = m.forward(p, {"tokens": torch.from_numpy(toks)})
    _close(pf, jf, F32_RTOL)
