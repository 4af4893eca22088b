"""The port's LM serving path against the JAX package on reduced configs:
configs, parameter specs, the layers (``rms_norm``, ``apply_rope``,
``cache_write``, ``attention_decode``), ``prefill``/``decode_step``/``forward``
and the caches of ``LM``, and ``ServeEngine`` in the reference's serving
scenarios.  Weights are the reference's, carried over leaf for leaf by
``convert.lm_params_from_numpy``; the JAX model runs with ``use_pallas=True``
(its flash kernel in interpret mode, the arm the port's attention follows)
where logits are compared.

Tolerances.  f32 logits and layer outputs: rtol 1e-5, atol 1e-5 * max|ref|
(the order of the f32 sums, exp and the rope's pow differ from XLA's).  The
bf16 KV cache: positions exact; keys and values within one bf16 step (rtol
2^-7, and the f32 atol above), because an f32 value that differs in its
last bit from the reference's can round to the neighbouring bf16 value.  Decode logits are
compared twice: from the reference's own cache (identical inputs: 1e-5), and
each model from its own cache, within 2e-3 * max|logit|, a few such bf16
steps in the attention sums.  The engines must decode the same tokens."""
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
from repro.runtime import RuntimeConfig as JRuntimeConfig
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.configs import LayerSpec, get_config, list_archs, reduced_config
from repro_torch.models import layers, spec
from repro_torch.models.transformer import LM, model_specs
from repro_torch.runtime import RuntimeConfig
from repro_torch.serving import Request, ServeConfig, ServeEngine
from repro_torch.serving.engine import merge_slot

ARCHS = ["qwen3-0.6b", "gemma3-1b"]
OWN_CACHE_TOL = 2e-3


def close(got, want, rtol=1e-5):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    """(JAX config with use_pallas, JAX model, JAX params, port config, port
    model, port params) for one reduced arch."""
    jcfg = jreduced_config(jget_config(request.param)).replace(use_pallas=True)
    jm = JLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = reduced_config(get_config(request.param))
    return jcfg, jm, jp, cfg, LM(cfg, device="cpu"), convert.lm_params_from_numpy(
        to_np(jp), device="cpu")


# ---------------------------------------------------------------- configs, specs


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_references(arch):
    for make in (lambda g: g(arch), lambda g: (jreduced_config if g is jget_config
                                               else reduced_config)(g(arch))):
        port, ref = make(get_config), make(jget_config)
        for f in dataclasses.fields(port):
            want = getattr(ref, f.name)
            got = getattr(port, f.name)
            if f.name.endswith("_pattern"):
                got, want = [(s.mixer, s.ffn) for s in got], [(s.mixer, s.ffn) for s in want]
            assert got == want, f.name
        for prop in ("num_layers", "q_dim", "kv_dim", "padded_vocab", "gqa_groups"):
            assert getattr(port, prop) == getattr(ref, prop), prop
    assert list_archs() == sorted(ARCHS + ["granite-moe-1b-a400m", "kimi-k2-1t-a32b",
                                           "qwen3-4b", "starcoder2-15b"])


def test_get_config_refuses_unported_archs_and_from_arch_follows_the_reference():
    with pytest.raises(KeyError, match="not ported"):
        get_config("xlstm-1.3b")
    for arch in ARCHS:
        cfg = get_config(arch).replace(router_policy="arype_only")
        ref = JRuntimeConfig.from_arch(jget_config(arch).replace(router_policy="arype_only"))
        port = RuntimeConfig.from_arch(cfg)
        assert (port.policy, port.accum_dtype) == (ref.policy, ref.accum_dtype)
        assert (port.tau, port.mxu_tile, port.vpe_max_elems) == (ref.tau, ref.mxu_tile,
                                                                 ref.vpe_max_elems)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_specs_and_params_match_the_reference_leaf_for_leaf(arch):
    jcfg, cfg = jreduced_config(jget_config(arch)), reduced_config(get_config(arch))
    jspecs = jtransformer.model_specs(jcfg)
    ref_shapes = jax.tree.map(lambda s: (s.shape, s.init, s.dtype), jspecs,
                              is_leaf=lambda x: hasattr(x, "init"))
    port_shapes = spec.map_specs(lambda s: (s.shape, s.init, s.dtype), model_specs(cfg))
    assert port_shapes == ref_shapes
    abstract = LM(cfg, device="cpu").abstract_params()
    assert jax.tree.map(lambda t: (tuple(t.shape), t.device.type), abstract) == \
        spec.map_specs(lambda s: (s.shape, "meta"), model_specs(cfg))
    jp = to_np(JLM(jcfg).init(jax.random.PRNGKey(1)))
    port = convert.lm_params_from_numpy(jp, device="cpu")
    flat_ref = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_ref) == len(jax.tree.leaves(port))
    for path, leaf in flat_ref:
        got = port
        for key in path:
            got = got[key.key]
        assert got.dtype == torch.float32 and tuple(got.shape) == leaf.shape
        np.testing.assert_array_equal(got.numpy(), leaf)
    assert port["blocks"]["l0"]["mixer"]["wq"].shape[0] == cfg.num_superblocks


def test_init_params_draws_the_references_inits():
    cfg = reduced_config(get_config("qwen3-0.6b"))
    params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    again = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(params),
                                                 jax.tree.leaves(again)))
    assert torch.equal(params["final_norm"], torch.zeros(cfg.d_model))
    wq = params["blocks"]["l0"]["mixer"]["wq"]  # (L, d, q_dim): fan-in d
    assert abs(wq.std().item() * np.sqrt(cfg.d_model) - 1) < 0.05
    assert abs(params["embed"].std().item() / 0.02 - 1) < 0.05
    assert spec.ParamSpec((2, 3), (None, None), "ones").init == "ones"
    ones = spec.init_params({"w": spec.ParamSpec((2, 3), (None, None), "ones")},
                            torch.Generator(), device="cpu")
    assert torch.equal(ones["w"], torch.ones(2, 3))


def test_lm_refuses_what_this_slice_does_not_run():
    base = reduced_config(get_config("qwen3-0.6b"))
    for kw, match in ((dict(block_pattern=(LayerSpec("mamba2", "none"),)), "mamba2"),
                      (dict(block_pattern=(LayerSpec("attn_cross", "mlp"),)), "attn_cross"),
                      (dict(block_pattern=(LayerSpec("attn", "mlp_shared"),)), "mlp_shared"),
                      (dict(frontend="audio_frames"), "frontend"),
                      (dict(param_dtype="float16"), "param_dtype"),
                      (dict(attn_logit_softcap=30.0), "softcap")):
        with pytest.raises(NotImplementedError, match=match):
            LM(base.replace(**kw), device="cpu")
    cfg = get_config("qwen3-0.6b")  # registered default: bf16 compute on f32 weights
    assert LM(cfg, device="cpu").cfg.compute_dtype == "bfloat16"


def test_lm_and_engine_refuse_to_run_without_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cfg = reduced_config(get_config("qwen3-0.6b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LM(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg, {}, ServeConfig())


# ---------------------------------------------------------------- layers


def test_rms_norm_and_rope_match_the_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32) * 0.1
    close(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
          jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    pos = rng.integers(0, 5000, (2, 9)).astype(np.int32)
    for theta in (1e4, 1e6):
        close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
              jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("kind,cap,lengths,s_new", [
    ("causal", 16, (0, 5), 7),     # plain writes
    ("causal", 16, (10, 14), 6),   # past the end: clamped at cap - 1, the last token stays
    ("local", 8, (0, 3), 5),       # ring
    ("local", 8, (6, 2), 13),      # the ring wraps within one write: the last tokens stay
])
def test_cache_write_matches_the_reference(kind, cap, lengths, s_new):
    cfg = reduced_config(get_config("gemma3-1b")).replace(window_size=cap)
    rng = np.random.default_rng(cap + s_new)
    k0, v0 = (rng.standard_normal((2, cap, 1, 16)).astype(np.float32) for _ in range(2))
    pos0 = rng.integers(-1, 3, (2, cap)).astype(np.int32)
    kn, vn = (rng.standard_normal((2, s_new, 1, 16)).astype(np.float32) for _ in range(2))
    lens = np.asarray(lengths, np.int32)
    ref = jlayers.cache_write(
        jlayers.AttnCache(jnp.asarray(k0, jnp.bfloat16), jnp.asarray(v0, jnp.bfloat16),
                          jnp.asarray(pos0)),
        jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(lens), kind=kind, window=cap)
    cache = layers.AttnCache(torch.from_numpy(k0).bfloat16(), torch.from_numpy(v0).bfloat16(),
                             torch.from_numpy(pos0))
    got = layers.cache_write(cache, torch.from_numpy(kn), torch.from_numpy(vn),
                             torch.from_numpy(lens), kind=kind)
    assert got.k is cache.k  # written in place
    for name, a, b in zip(got._fields, got, ref):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32), err_msg=name)
    assert cfg.window_size == cap


@pytest.mark.parametrize("kind,window", [("causal", 0), ("local", 6)])
def test_attention_decode_matches_the_reference(kind, window):
    rng = np.random.default_rng(window)
    cap, lens = 12, np.asarray([3, 11], np.int32)
    k, v = (rng.standard_normal((2, cap, 2, 16)).astype(np.float32) for _ in range(2))
    pos = np.stack([np.r_[np.arange(5), -np.ones(cap - 5)], np.arange(cap)]).astype(np.int32)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    ref = jlayers.attention_decode(
        jnp.asarray(q), jlayers.AttnCache(jnp.asarray(k, jnp.bfloat16),
                                          jnp.asarray(v, jnp.bfloat16), jnp.asarray(pos)),
        jnp.asarray(lens), kind=kind, window=window)
    got = layers.attention_decode(
        torch.from_numpy(q), layers.AttnCache(torch.from_numpy(k).bfloat16(),
                                              torch.from_numpy(v).bfloat16(),
                                              torch.from_numpy(pos)),
        torch.from_numpy(lens), kind=kind, window=window)
    close(got, ref)


# ---------------------------------------------------------------- the model


def _caches_close(port: dict, ref: dict) -> None:
    ref = convert.lm_cache_from_numpy(to_np(ref), device="cpu")
    np.testing.assert_array_equal(port["lengths"].numpy(), ref["lengths"].numpy())
    for key in port:
        if key == "lengths":
            continue
        pairs = ([(port[key][n], ref[key][n]) for n in port[key]] if key == "blocks"
                 else [(port[key], ref[key])])
        for got, want in pairs:
            np.testing.assert_array_equal(got.pos.numpy(), want.pos.numpy())
            for a, b in ((got.k, want.k), (got.v, want.v)):
                a, b = a.float().numpy(), b.float().numpy()
                np.testing.assert_allclose(a, b, rtol=2**-7, atol=1e-5 * np.abs(b).max())
                assert (a == b).mean() > 0.95  # most entries round alike


def test_prefill_decode_and_forward_match_the_reference(models):
    jcfg, jm, jp, cfg, m, p = models
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 21))  # past gemma3's reduced window of 16
    jtoks = {"tokens": jnp.asarray(toks, jnp.int32)}
    jl, jc = jax.jit(jm.prefill)(jp, jtoks, jm.init_cache(2, 32))
    pl, pc = m.prefill(p, {"tokens": torch.from_numpy(toks)}, m.init_cache(2, 32))
    assert pl.shape == (2, 1, cfg.padded_vocab)
    close(pl, jl)
    _caches_close(pc, jc)

    nxt = np.asarray(jnp.argmax(jl[:, -1, :cfg.vocab_size], axis=-1))[:, None]
    jl2, jc2 = jax.jit(jm.decode_step)(jp, {"tokens": jnp.asarray(nxt, jnp.int32)}, jc)
    # from the reference's own cache: identical inputs
    nxt = np.array(nxt)  # writable, for torch
    pl2, _ = m.decode_step(p, {"tokens": torch.from_numpy(nxt)},
                           convert.lm_cache_from_numpy(to_np(jc), device="cpu"))
    close(pl2, jl2)
    # from the port's own cache
    pl3, pc3 = m.decode_step(p, {"tokens": torch.from_numpy(nxt)}, pc)
    close(pl3, jl2, rtol=OWN_CACHE_TOL)
    _caches_close(pc3, jc2)

    jf, jaux = jax.jit(jm.forward)(jp, jtoks)
    pf, paux = m.forward(p, {"tokens": torch.from_numpy(toks)})
    close(pf, jf)
    assert float(paux) == float(jaux) == 0.0


def test_padded_vocab_is_masked(models):
    jcfg, jm, jp, cfg, m, p = models
    cfg2 = cfg.replace(vocab_size=cfg.vocab_size - 5)
    jcfg2 = jcfg.replace(vocab_size=jcfg.vocab_size - 5)
    toks = np.random.default_rng(2).integers(0, cfg2.vocab_size, (1, 6))
    pf, _ = LM(cfg2, device="cpu").forward(p, {"tokens": torch.from_numpy(toks)})
    jf, _ = jax.jit(JLM(jcfg2).forward)(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    assert (pf[..., cfg2.vocab_size:] == -1e30).all()
    close(pf, jf)


# ---------------------------------------------------------------- serving


_JITS: dict = {}


def reference_greedy(jm, jp, prompt, max_new, cache_len=96):
    """The single-request greedy reference of tests/test_serving.py (its two
    steps jitted once per model)."""
    prefill, decode = _JITS.setdefault(id(jm), (jax.jit(jm.prefill), jax.jit(jm.decode_step)))
    cache = jm.init_cache(1, cache_len)
    logits, cache = prefill(jp, {"tokens": jnp.asarray(prompt, jnp.int32)[None]}, cache)
    toks = [int(jnp.argmax(logits[0, -1, : jm.cfg.vocab_size]))]
    for _ in range(max_new - 1):
        lg, cache = decode(jp, {"tokens": jnp.asarray([[toks[-1]]], jnp.int32)}, cache)
        toks.append(int(jnp.argmax(lg[0, 0, : jm.cfg.vocab_size])))
    return toks


@pytest.fixture(scope="module")
def qwen():
    """Reduced qwen3-0.6b as tests/test_serving.py serves it (the JAX
    engine on its default path), with the port's copy of the weights."""
    jcfg = jreduced_config(jget_config("qwen3-0.6b"))
    jm = JLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = reduced_config(get_config("qwen3-0.6b"))
    return jcfg, jm, jp, cfg, convert.lm_params_from_numpy(to_np(jp), device="cpu")


def serve_both(qwen, prompts, max_new, eos_id=-1, **sc):
    jcfg, _, jp, cfg, p = qwen
    jeng = JServeEngine(jcfg, jp, JServeConfig(eos_id=eos_id, **sc))
    eng = ServeEngine(cfg, p, ServeConfig(eos_id=eos_id, **sc), device="cpu")
    out = []
    for engine, req in ((jeng, JRequest), (eng, Request)):
        reqs = [req(rid=i, prompt=pr, max_new=max_new) for i, pr in enumerate(prompts)]
        for r in reqs:
            engine.submit(r)
        done = engine.run_until_drained()
        out.append((reqs, done))
    (jreqs, jdone), (reqs, done) = out
    assert len(done) == len(jdone) == len(prompts)
    for a, b in zip(reqs, jreqs):
        assert a.out_tokens == b.out_tokens, (a.rid, a.out_tokens, b.out_tokens)
    return eng, reqs


def test_engine_matches_reference_engine(qwen):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, qwen[3].vocab_size, 8 + i) for i in range(3)]
    _, reqs = serve_both(qwen, prompts, 6, batch_slots=2, cache_len=96)
    for r, prompt in zip(reqs, prompts):
        assert r.out_tokens == reference_greedy(qwen[1], qwen[2], prompt, 6)


def test_engine_more_requests_than_slots_matches_reference_engine(qwen):
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, qwen[3].vocab_size, 4) for _ in range(5)]
    eng, reqs = serve_both(qwen, prompts, 4, batch_slots=2, cache_len=64)
    assert all(len(r.out_tokens) == 4 for r in reqs)
    assert eng.stats.prefills == 5 and eng.stats.tokens == 20


def test_engine_single_slot_exhaustion_matches_reference_engine(qwen):
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, qwen[3].vocab_size, 5 + i) for i in range(3)]
    eng, reqs = serve_both(qwen, prompts, 5, batch_slots=1, cache_len=96)
    assert not eng.queue and not eng.active.any()


def test_engine_eos_early_stop_matches_reference_engine(qwen):
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, qwen[3].vocab_size, 6)
    ref = reference_greedy(qwen[1], qwen[2], prompt, 8)
    eos = ref[2]
    follower = rng.integers(0, qwen[3].vocab_size, 4)
    _, reqs = serve_both(qwen, [prompt, follower], 8, eos_id=eos, batch_slots=1, cache_len=96)
    early = reqs[0]
    assert early.out_tokens == ref[:ref.index(eos, 1) + 1] and len(early.out_tokens) < 8


def test_engine_reset_reuse_matches_reference_engine(qwen):
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, qwen[3].vocab_size, 6) for _ in range(3)]
    eng, first = serve_both(qwen, prompts, 4, batch_slots=2, cache_len=64)
    eng.reset()
    assert eng.queue == [] and eng.slots == [None, None] and not eng.active.any()
    assert int(eng.cache["lengths"].sum()) == 0 and eng.stats.tokens == 0
    again = [Request(rid=i, prompt=p, max_new=4) for i, p in enumerate(prompts)]
    for r in again:
        eng.submit(r)
    eng.run_until_drained()
    assert [r.out_tokens for r in again] == [r.out_tokens for r in first]


@pytest.fixture(scope="module")
def gemma():
    """Reduced gemma3-1b (2 superblocks of 5 local + 1 global, 2 local tail
    layers, window 16) and three prompts longer than the window."""
    jcfg = jreduced_config(jget_config("gemma3-1b"))
    jm = JLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = reduced_config(get_config("gemma3-1b"))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, 20 + i) for i in range(3)]
    refs = [reference_greedy(jm, jp, pr, 8, cache_len=64) for pr in prompts]
    return jcfg, jm, jp, cfg, convert.lm_params_from_numpy(to_np(jp), device="cpu"), prompts, refs


def _serve(engine, req, prompts, max_new=8):
    reqs = [req(rid=i, prompt=p, max_new=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    return [r.out_tokens for r in reqs]


def test_gemma3_engine_at_three_slots_matches_reference_engine(gemma):
    jcfg, _, jp, cfg, p, prompts, refs = gemma
    sc = dict(batch_slots=3, cache_len=64)
    jtoks = _serve(JServeEngine(jcfg, jp, JServeConfig(**sc)), JRequest, prompts)
    toks = _serve(ServeEngine(cfg, p, ServeConfig(**sc), device="cpu"), Request, prompts)
    assert toks == jtoks == refs


def test_gemma3_engine_at_two_slots_matches_single_request_reference(gemma):
    """batch_slots == num_superblocks: the port merges each admitted slot by
    the cache's structure and decodes the single-request tokens."""
    _, _, _, cfg, p, prompts, refs = gemma
    assert cfg.num_superblocks == 2
    eng = ServeEngine(cfg, p, ServeConfig(batch_slots=2, cache_len=64), device="cpu")
    assert _serve(eng, Request, prompts) == refs


def test_reference_merge_slot_fault_at_two_slots(gemma):
    """The reference fault the port does not copy (ROADMAP Queue 3): with
    ``batch_slots == num_superblocks`` the reference's ``_merge_slot`` takes
    axis 0 of the unstacked tail caches for a superblock axis and merges
    slot rows the wrong way, so its engine decodes other tokens than its own
    single-request reference."""
    jcfg, _, jp, _, _, prompts, refs = gemma
    jtoks = _serve(JServeEngine(jcfg, jp, JServeConfig(batch_slots=2, cache_len=64)), JRequest,
                   prompts)
    assert jtoks != refs


def test_merge_slot_copies_one_slot_by_structure():
    cfg = reduced_config(get_config("gemma3-1b"))
    m = LM(cfg, device="cpu")
    old, new = m.init_cache(2, 8), m.init_cache(2, 8)
    for cache, value in ((old, 1.0), (new, 2.0)):
        for leaf in jax.tree.leaves(cache):
            leaf.fill_(value)
    merge_slot(old, new, 1)
    stacked = old["blocks"]["l0"].k  # (superblocks, B, C, H, D)
    assert (stacked[:, 1] == 2).all() and (stacked[:, 0] == 1).all()
    tail = old["tail0"].pos  # (B, C)
    assert (tail[1] == 2).all() and (tail[0] == 1).all()
    assert (old["lengths"] == 1).all()
