"""The port's mixture of experts against the JAX package on the CPU:
``moe_capacity``, ``_dispatch_indices``, ``moe_route``/``moe_apply`` on
reduced granite-moe-1b-a400m and reduced kimi-k2-1t-a32b (its shared expert
and dense first layer), in f32 and in bf16 compute, and the LM built on it:
``prefill``/``decode_step``/``forward`` and ``ServeEngine`` in
``test_torch_lm.py``'s serving scenarios.  Weights are the reference's,
carried over by ``convert.lm_params_from_numpy``.

Tolerances (set before any comparison ran).  Integer work (capacities,
slots, keeps, expert ids) is exact.  f32 outputs and logits: rtol 1e-5,
atol 1e-5 * max|ref|, the order of the f32 sums (the combine adds a token's
entries in entry order, as the reference's scatter-add does, so only the
products' sums differ).  The aux loss: 1e-6 absolute (a sum of E products
of means of f32 probabilities, each of order 1/E).  bf16 compute: the
output is x + y rounded to bf16, and y is rounded to bf16 after the gated
product was; an f32 sum that differs in its last bit can move each of these
roundings by one step, so the output may differ by two bf16 steps of its
value (plus 1e-6 * max|ref| near 0).  The JAX side runs with
``xla_allow_excess_precision`` off (see ``test_torch_bf16.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced_config
from repro.models import LM as JLM
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.models.spec import init_params as jinit_params
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import layers, spec
from repro_torch.models.transformer import LM, model_specs
from repro_torch.serving import Request, ServeConfig, ServeEngine

MOE_ARCHS = ["granite-moe-1b-a400m", "kimi-k2-1t-a32b"]
RTOL = 1e-5
AUX_ATOL = 1e-6
EXACT = {"xla_allow_excess_precision": False}


def close(got, want, rtol=RTOL):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def configs(arch, **kw):
    return jreduced_config(jget_config(arch)).replace(**kw), \
        reduced_config(get_config(arch)).replace(**kw)


# ---------------------------------------------------------------- configs


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_configs_equal_the_references(arch):
    for port, ref in ((get_config(arch), jget_config(arch)),
                      (reduced_config(get_config(arch)), jreduced_config(jget_config(arch)))):
        for f in dataclasses.fields(port):
            got, want = getattr(port, f.name), getattr(ref, f.name)
            if f.name.endswith("_pattern"):
                got, want = [(s.mixer, s.ffn) for s in got], [(s.mixer, s.ffn) for s in want]
            assert got == want, f.name
        assert port.padded_vocab == ref.padded_vocab and port.num_layers == ref.num_layers
    jcfg, cfg = configs(arch)
    ref = jax.tree.map(lambda s: (s.shape, s.init, s.dtype), jtransformer.model_specs(jcfg),
                       is_leaf=lambda x: hasattr(x, "init"))
    assert spec.map_specs(lambda s: (s.shape, s.init, s.dtype), model_specs(cfg)) == ref


def test_full_kimi_stays_refused_and_granite_is_served_as_registered():
    """Full kimi-k2 builds (its bf16 weights are ported) but stays reduced
    everywhere: its 1.03 T parameters hold 2 TB in bf16, past one card."""
    kimi = LM(get_config("kimi-k2-1t-a32b"), device="cpu")
    leaves = jax.tree.leaves(kimi.abstract_params())
    assert {t.dtype for t in leaves} == {torch.bfloat16, torch.float32}  # the router is f32
    assert sum(t.numel() for t in leaves) > 1.0e12
    assert sum(t.numel() * t.element_size() for t in leaves) > 80e9 * 20
    cfg = get_config("granite-moe-1b-a400m")
    m = LM(cfg, device="cpu")
    n = sum(t.numel() for t in jax.tree.leaves(m.abstract_params()))
    assert 1.3e9 < n < 1.5e9 and cfg.padded_vocab == 49280
    assert (cfg.compute_dtype, cfg.param_dtype) == ("bfloat16", "float32")


# ---------------------------------------------------------------- dispatch


def test_moe_capacity_matches_the_reference():
    for arch in MOE_ARCHS:
        for cf in (0.25, 1.0, 1.25, 8.0):
            jcfg, cfg = (c.replace(capacity_factor=cf)
                         for c in (jget_config(arch), get_config(arch)))
            for t in (1, 2, 3, 7, 12, 64, 300, 4096):
                assert layers.moe_capacity(t, cfg) == jlayers.moe_capacity(t, jcfg), (arch, cf, t)
    # four decode slots of granite: one token a group, one slot an expert
    assert layers.moe_capacity(1, get_config("granite-moe-1b-a400m")) == 1


@pytest.mark.parametrize("tk,e,cap,seed", [(24, 4, 8, 0),    # no drops
                                           (24, 4, 3, 1),    # overflow
                                           (64, 32, 1, 2),   # one slot an expert
                                           (40, 5, 2, 3)])
def test_dispatch_indices_match_the_reference_bit_for_bit(tk, e, cap, seed):
    rng = np.random.default_rng(seed)
    eidx = rng.integers(0, e, (3, tk)).astype(np.int32)
    eidx[0] = 1  # every entry on one expert: all but cap drop
    for row in eidx:
        jslot, jkeep = jlayers._dispatch_indices(jnp.asarray(row), e, cap)
        slot, keep = layers._dispatch_indices(torch.from_numpy(row), e, cap)
        np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
        np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    # the batched form (groups on the leading axis) equals the rows one by one
    slot, keep = layers._dispatch_indices(torch.from_numpy(eidx), e, cap)
    for i, row in enumerate(eidx):
        jslot, jkeep = jlayers._dispatch_indices(jnp.asarray(row), e, cap)
        np.testing.assert_array_equal(slot[i].numpy(), np.asarray(jslot))
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(jkeep))
    assert int((~keep[0]).sum()) == tk - cap


# ---------------------------------------------------------------- moe_apply

_JIT_MOE: dict = {}


def reference_moe(jcfg, jp, x, groups, compiler_options=None):
    """The reference's ``moe_apply``, jitted once per (config, groups)."""
    key = (jcfg, groups, bool(compiler_options))
    if key not in _JIT_MOE:
        _JIT_MOE[key] = jax.jit(
            lambda p, x: jlayers.moe_apply(p, x, jcfg, num_groups=groups),
            compiler_options=compiler_options)
    return _JIT_MOE[key](jp, x)


@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_layer(request):
    """(arch, JAX params, port params) of one reduced arch's MoE layer."""
    jcfg, _ = configs(request.param)
    jp = jinit_params(jlayers.moe_specs(jcfg), jax.random.PRNGKey(0))
    return request.param, jp, convert.lm_params_from_numpy(to_np(jp), device="cpu")


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("capacity_factor", [None, 0.25], ids=["no-drops", "drops"])
def test_moe_apply_matches_the_reference(moe_layer, groups, capacity_factor):
    arch, jp, p = moe_layer
    kw = {} if capacity_factor is None else dict(capacity_factor=capacity_factor)
    jcfg, cfg = configs(arch, **kw)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 12, cfg.d_model))) * 0.5
    jout, jaux = reference_moe(jcfg, jp, jnp.asarray(x), groups)
    out, aux = layers.moe_apply(p, torch.from_numpy(x.copy()), cfg, num_groups=groups)
    close(out, jout)
    assert abs(float(aux) - float(jaux)) <= AUX_ATOL
    # the capacity and the expert ids behind it
    t = 24 // groups
    h = layers.rms_norm(torch.from_numpy(x.copy()), p["ln"]).reshape(groups, t, cfg.d_model)
    probs, gates, ids = layers.moe_route(p["router"], h, cfg.experts_per_token)
    jh = jlayers.rms_norm(jnp.asarray(x), jp["ln"]).reshape(groups, t, cfg.d_model)
    jprobs = jax.nn.softmax(jnp.einsum("gtd,de->gte", jh, jp["router"]), axis=-1)
    jgates, jids = jax.lax.top_k(jprobs, cfg.experts_per_token)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    close(probs, jprobs)
    slot, keep = layers._dispatch_indices(ids.reshape(groups, -1), cfg.num_experts,
                                          layers.moe_capacity(t, cfg))
    if capacity_factor is not None:
        assert (~keep).any()  # some entries dropped
    else:
        assert keep.all()


def test_zero_router_ties_give_the_reference_slots():
    """Every probability equal: the top k are the first k experts in index
    order, as ``lax.top_k`` orders ties, and drops follow entry order."""
    jcfg, cfg = configs("granite-moe-1b-a400m", capacity_factor=1.0)
    jp = jinit_params(jlayers.moe_specs(jcfg), jax.random.PRNGKey(3))
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    p = convert.lm_params_from_numpy(to_np(jp), device="cpu")
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (1, 10, cfg.d_model)))
    h = layers.rms_norm(torch.from_numpy(x.copy()), p["ln"]).reshape(1, 10, cfg.d_model)
    _, gates, ids = layers.moe_route(p["router"], h, cfg.experts_per_token)
    assert (ids == torch.arange(cfg.experts_per_token)).all()
    assert torch.equal(gates, torch.full_like(gates, 1 / cfg.experts_per_token))
    cap = layers.moe_capacity(10, cfg)
    slot, keep = layers._dispatch_indices(ids.reshape(1, -1), cfg.num_experts, cap)
    jslot, jkeep = jlayers._dispatch_indices(jnp.asarray(ids.reshape(-1).numpy()),
                                             cfg.num_experts, cap)
    np.testing.assert_array_equal(slot[0].numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(keep[0].numpy(), np.asarray(jkeep))
    assert int(keep.sum()) == 2 * cap  # experts 0 and 1 fill, the rest drop
    jout, jaux = reference_moe(jcfg, jp, jnp.asarray(x), 1)
    out, aux = layers.moe_apply(p, torch.from_numpy(x.copy()), cfg, num_groups=1)
    close(out, jout)
    assert abs(float(aux) - float(jaux)) <= AUX_ATOL


def bf16_step(v: np.ndarray) -> np.ndarray:
    """One bf16 step (ulp) at each |v|: 2^(e - 7) for |v| in [2^e, 2^(e+1))."""
    e = np.floor(np.log2(np.maximum(np.abs(v), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("groups", [1, 2])
def test_moe_apply_bf16_compute_matches_the_reference(moe_layer, groups, record_property):
    arch, jp, p = moe_layer
    jcfg, cfg = configs(arch, compute_dtype="bfloat16")
    x = jnp.asarray(np.asarray(jax.random.normal(jax.random.PRNGKey(5), (2, 12, cfg.d_model))),
                    jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).bfloat16()
    jout, jaux = reference_moe(jcfg, jp, x, groups, compiler_options=EXACT)
    out, aux = layers.moe_apply(p, xt, cfg, num_groups=groups)
    assert out.dtype == torch.bfloat16 and aux.dtype == torch.float32
    want = np.asarray(jout.astype(jnp.float32))
    diff = np.abs(out.float().numpy() - want)
    assert (diff <= 2 * bf16_step(want) + 1e-6 * np.abs(want).max()).all(), diff.max()
    record_property("share_differing", float((diff > 0).mean()))
    assert abs(float(aux) - float(jaux)) <= AUX_ATOL


# ---------------------------------------------------------------- the LM


@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_models(request):
    """(JAX model with use_pallas, JAX params, port config, port model, port
    params) for one reduced MoE arch."""
    jcfg, cfg = configs(request.param)
    jm = JLM(jcfg.replace(use_pallas=True))
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, cfg, LM(cfg, device="cpu"), convert.lm_params_from_numpy(to_np(jp),
                                                                             device="cpu")


def test_moe_lm_prefill_decode_and_forward_match_the_reference(moe_models):
    jm, jp, cfg, m, p = moe_models
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 21))
    jtoks = {"tokens": jnp.asarray(toks, jnp.int32)}
    jl, jc = jax.jit(jm.prefill)(jp, jtoks, jm.init_cache(2, 32))
    pl, pc = m.prefill(p, {"tokens": torch.from_numpy(toks)}, m.init_cache(2, 32))
    close(pl, jl)
    nxt = np.array(np.asarray(jnp.argmax(jl[:, -1, :cfg.vocab_size], axis=-1))[:, None])
    assert (pl[:, -1, :cfg.vocab_size].argmax(-1).numpy() == nxt[:, 0]).all()
    jl2, _ = jax.jit(jm.decode_step)(jp, {"tokens": jnp.asarray(nxt, jnp.int32)}, jc)
    pl2, _ = m.decode_step(p, {"tokens": torch.from_numpy(nxt)},
                           convert.lm_cache_from_numpy(to_np(jc), device="cpu"))
    close(pl2, jl2)
    jf, jaux = jax.jit(jm.forward)(jp, jtoks)
    pf, paux = m.forward(p, {"tokens": torch.from_numpy(toks)})
    close(pf, jf)
    assert float(jaux) > 0 and abs(float(paux) - float(jaux)) <= cfg.num_layers * AUX_ATOL


_JITS: dict = {}


def reference_greedy(jm, jp, prompt, max_new, cache_len=96):
    prefill, decode = _JITS.setdefault(id(jm), (jax.jit(jm.prefill), jax.jit(jm.decode_step)))
    cache = jm.init_cache(1, cache_len)
    logits, cache = prefill(jp, {"tokens": jnp.asarray(prompt, jnp.int32)[None]}, cache)
    toks = [int(jnp.argmax(logits[0, -1, : jm.cfg.vocab_size]))]
    for _ in range(max_new - 1):
        lg, cache = decode(jp, {"tokens": jnp.asarray([[toks[-1]]], jnp.int32)}, cache)
        toks.append(int(jnp.argmax(lg[0, 0, : jm.cfg.vocab_size])))
    return toks


@pytest.fixture(scope="module")
def granite():
    """Reduced granite as the reference's engine serves it (its default
    path), with the port's copy of the weights."""
    jcfg, cfg = configs("granite-moe-1b-a400m")
    jm = JLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jcfg, jm, jp, cfg, convert.lm_params_from_numpy(to_np(jp), device="cpu")


def serve_both(granite, prompts, max_new, eos_id=-1, **sc):
    jcfg, _, jp, cfg, p = granite
    jeng = JServeEngine(jcfg, jp, JServeConfig(eos_id=eos_id, **sc))
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
    for a, b in zip(reqs, jreqs):
        assert a.out_tokens == b.out_tokens, (a.rid, a.out_tokens, b.out_tokens)
    return eng, reqs


def _prompts(seed, lens, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n) for n in lens]


@pytest.mark.parametrize("scenario", ["matches", "more_requests_than_slots",
                                      "single_slot_exhaustion", "eos_early_stop",
                                      "reset_reuse"])
def test_granite_engine_matches_the_reference_engine(granite, scenario):
    """``test_torch_lm.py``'s serving scenarios on reduced granite."""
    jm, jp, vocab = granite[1], granite[2], granite[3].vocab_size
    if scenario == "matches":
        prompts = _prompts(0, (8, 9, 10), vocab)
        _, reqs = serve_both(granite, prompts, 6, batch_slots=2, cache_len=96)
        for r, prompt in zip(reqs, prompts):
            assert r.out_tokens == reference_greedy(jm, jp, prompt, 6)
    elif scenario == "more_requests_than_slots":
        eng, reqs = serve_both(granite, _prompts(1, (4,) * 5, vocab), 4, batch_slots=2,
                               cache_len=64)
        assert eng.stats.prefills == 5 and eng.stats.tokens == 20
    elif scenario == "single_slot_exhaustion":
        eng, _ = serve_both(granite, _prompts(2, (5, 6, 7), vocab), 5, batch_slots=1,
                            cache_len=96)
        assert not eng.queue and not eng.active.any()
    elif scenario == "eos_early_stop":
        prompt, follower = _prompts(3, (6, 4), vocab)
        ref = reference_greedy(jm, jp, prompt, 8)
        eos = ref[2]
        _, reqs = serve_both(granite, [prompt, follower], 8, eos_id=eos, batch_slots=1,
                             cache_len=96)
        assert reqs[0].out_tokens == ref[:ref.index(eos, 1) + 1]
    else:
        prompts = _prompts(4, (6,) * 3, vocab)
        eng, first = serve_both(granite, prompts, 4, batch_slots=2, cache_len=64)
        eng.reset()
        again = [Request(rid=i, prompt=p, max_new=4) for i, p in enumerate(prompts)]
        for r in again:
            eng.submit(r)
        eng.run_until_drained()
        assert [r.out_tokens for r in again] == [r.out_tokens for r in first]


def test_moe_decode_groups_are_one_token_each():
    """Decode at 4 slots: min(B, 8) groups of one token, capacity 1, so no
    entry drops (a token's k experts are distinct); prefill: one group a
    row."""
    cfg = reduced_config(get_config("granite-moe-1b-a400m")).replace(capacity_factor=1.25)
    assert layers.moe_capacity(1, cfg) == 1
    p = spec.init_params(layers.moe_specs(cfg), torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn(4, 1, cfg.d_model, generator=torch.Generator().manual_seed(1))
    whole, _ = layers.moe_apply(p, x, cfg)
    rows = torch.cat([layers.moe_apply(p, x[i:i + 1], cfg)[0] for i in range(4)])
    close(whole, rows.numpy())
