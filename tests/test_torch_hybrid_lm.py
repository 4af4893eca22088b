"""The port's recurrent and hybrid LMs, xlstm-1.3b (mLSTM and sLSTM blocks)
and zamba2-2.7b (mamba2 blocks and a shared attention + MLP block), against
the JAX package on reduced configs: configs and specs, ``forward``,
``prefill`` and ``decode_step`` with their caches, each layer on the
reference's own inputs, the loss and every gradient, ``ServeEngine``, the
constant-size decode state, the cache conversions and the entry points
(``launch/serve.py``, ``examples/serve_lm_torch.py``).  Weights are the
reference's, carried over leaf for leaf by ``convert.lm_params_from_numpy``;
token batches come from a numpy seed.

Tolerances.  Each layer on the reference's own inputs: rtol 1e-5, atol
1e-5 * max|ref| (the order of the f32 sums, ``exp`` and ``log1p`` differ
from XLA's).  The whole model: logits and f32 cache leaves within ``tol``
of their max|ref|, ``tol`` = max(1e-5, ``CONDITIONING`` times what a
one-ulp change of the embedding table moves the reference's own f32
outputs), measured each run (the ``ref`` fixture); zamba2's bf16 KV cache
within one bf16 step and mostly equal, as ``tests/test_torch_lm.py`` holds
it.  The factor: another order of the f32 sums puts about an ulp into every
operation of every layer, not one at the input; the distance over that move
read 0.48 (xlstm) and 1.0 (zamba2), so 3 leaves room on both sides.  Reduced
zamba2's outputs move by under 2e-5; reduced xlstm's random-weight mLSTM
stack amplifies a last-bit difference at a layer's input 1.5- to 4-fold a
layer, so 2e-7 to 7e-7 of a layer's own error reaches the logits as some
3e-5 to 5e-5, and its own outputs move by 1.1e-4 under the one-ulp change.
A flat rtol of 1e-5 on the whole model does not hold: the port reads
5.4e-5 (xlstm) and 1.8e-5 (zamba2) of max|logit|, each layer within 1e-5.
Gradients: each leaf within max(1e-5, ``CONDITIONING`` times the
reference's own one-ulp move over all leaves) of its max|grad|, the same
rule (read: 0.53 and 1.19 of that move; 1.4e-4 and 9.5e-6 of max|grad|).
Types equal leaf for leaf.  The engines decode the same tokens."""
import dataclasses
import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced_config
from repro.models import LM as JLM
from repro.models import transformer as jtransformer
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServeEngine as JServeEngine
from repro.serving.engine import _merge_slot as j_merge_slot
from repro_torch import convert
from repro_torch.common.tree import tree_items
from repro_torch.configs import LayerSpec, get_config, reduced_config
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import recurrent as rec
from repro_torch.models import spec, transformer
from repro_torch.models.transformer import LM, check_supported, model_specs
from repro_torch.serving import Request, ServeConfig, ServeEngine
from repro_torch.serving.engine import merge_slot
from repro_torch.train.steps import grads_of

ARCHS = ["xlstm-1.3b", "zamba2-2.7b"]
RTOL = 1e-5
ULP = 2.0**-23
CONDITIONING = 3  # the limit over the reference's own one-ulp move (see above)
EXAMPLE = Path(__file__).resolve().parent.parent / "examples" / "serve_lm_torch.py"


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


def share(got, want) -> float:
    """max|got - want| as a share of max|want|."""
    g, w = np32(got), np32(want)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def close(got, want, rtol: float = RTOL, what: str = "") -> None:
    g, w = np32(got), np32(want)
    np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * max(np.abs(w).max(), 1e-30),
                               err_msg=what)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def cache_leaves(cache: dict):
    """(name, leaf) of every cache NamedTuple leaf, in a fixed order (the
    port's and the reference's caches name theirs alike)."""
    for key in sorted(cache):
        if key == "lengths":
            continue
        layers = cache[key] if key == "blocks" else {key: cache[key]}
        for name in sorted(layers):
            for field, leaf in zip(layers[name]._fields, layers[name]):
                yield f"{key}/{name}/{type(layers[name]).__name__}.{field}", leaf


# ---------------------------------------------------------------- the reference's runs


@dataclasses.dataclass
class Ref:
    jcfg: object
    jp: dict
    cfg: object
    params: dict
    toks: np.ndarray
    outputs: dict  # name -> the reference's array (logits, cache leaves)
    prefill_cache: dict
    decode: list  # (tokens (B, 1), logits, cache) of each decode step
    tol: float  # the model-level limit (see the module docstring)


def _ref_outputs(jm, jp, toks, decodes: int):
    """forward's logits; prefill's logits and cache; ``decodes`` decode steps
    (greedy tokens), each with its input tokens, logits and cache."""
    jt = {"tokens": jnp.asarray(toks, jnp.int32)}
    fwd, _ = jax.jit(jm.forward)(jp, jt)
    logits, cache = jax.jit(jm.prefill)(jp, jt, jm.init_cache(toks.shape[0], 32))
    steps, nxt, decode = [], None, jax.jit(jm.decode_step)
    out = {"forward": fwd, "prefill": logits}
    out.update(cache_leaves(cache))
    prefill_cache, c = cache, cache
    for i in range(decodes):
        nxt = np.asarray(jnp.argmax(logits[:, -1, :jm.cfg.vocab_size], axis=-1))[:, None]
        logits, c2 = decode(jp, {"tokens": jnp.asarray(nxt, jnp.int32)}, c)
        steps.append((nxt, logits, c2))
        out[f"decode{i}"] = logits
        out.update((f"decode{i}/{k}", v) for k, v in cache_leaves(c2))
        c = c2
    return out, prefill_cache, steps


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    """One reduced arch: the reference's model, its runs and the limit its
    own conditioning sets (``CONDITIONING`` times the largest share by which
    a one-ulp change of the embedding table moves any of its f32 outputs, at
    least 1e-5)."""
    arch = request.param
    jcfg = jreduced_config(jget_config(arch))
    jm = JLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = reduced_config(get_config(arch))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 19))
    outputs, prefill_cache, steps = _ref_outputs(jm, jp, toks, 4)
    nudged, _, _ = _ref_outputs(jm, dict(jp, embed=jp["embed"] * (1 + ULP)), toks, 4)
    moved = max(share(nudged[k], v) for k, v in outputs.items()
                if np.asarray(v).dtype == np.float32)
    return Ref(jcfg, jp, cfg, convert.lm_params_from_numpy(to_np(jp), device="cpu"), toks,
               outputs, prefill_cache, steps, max(RTOL, CONDITIONING * moved))


# ---------------------------------------------------------------- configs, specs


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_references(arch):
    for make in (lambda g: g(arch), lambda g: (jreduced_config if g is jget_config
                                               else reduced_config)(g(arch))):
        port, ref_cfg = make(get_config), make(jget_config)
        for f in dataclasses.fields(port):
            want, got = getattr(ref_cfg, f.name), getattr(port, f.name)
            if f.name.endswith("_pattern"):
                got, want = [(s.mixer, s.ffn) for s in got], [(s.mixer, s.ffn) for s in want]
            assert got == want, f.name
        for prop in ("num_layers", "q_dim", "kv_dim", "padded_vocab", "gqa_groups",
                     "ssm_d_inner", "ssm_heads", "mlstm_d_inner"):
            assert getattr(port, prop) == getattr(ref_cfg, prop), prop
    reduced = reduced_config(get_config(arch))
    # only an SSM config shrinks the chunk: reduced xlstm scans one chunk of 256
    assert reduced.ssm_chunk == (8 if arch.startswith("zamba2") else 256)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_specs_and_params_match_the_reference_leaf_for_leaf(arch):
    jcfg, cfg = jreduced_config(jget_config(arch)), reduced_config(get_config(arch))
    ref_shapes = jax.tree.map(lambda s: (s.shape, s.init, s.dtype),
                              jtransformer.model_specs(jcfg), is_leaf=lambda x: hasattr(x, "init"))
    assert spec.map_specs(lambda s: (s.shape, s.init, s.dtype), model_specs(cfg)) == ref_shapes
    jp = to_np(JLM(jcfg).init(jax.random.PRNGKey(1)))
    port = convert.lm_params_from_numpy(jp, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == len(jax.tree.leaves(port))
    for path, leaf in flat:
        got = port
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(got.numpy(), leaf)
    # zamba2's shared block: one attention and one MLP, no weights in its layers
    assert ("shared" in port) == arch.startswith("zamba2")
    if "shared" in port:
        assert sorted(port["shared"]) == ["ffn", "mixer"]
        assert port["blocks"]["l5"] == {"mixer": {}, "ffn": {}}


def test_init_draws_the_mamba_inits():
    """dt_bias is the softplus inverse of a uniform in [1e-3, 1e-1], A_log the
    log of one in [1, 16], drawn from the generator."""
    cfg = reduced_config(get_config("zamba2-2.7b")).replace(ssm_head_dim=1)  # 128 heads
    params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    again = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(again)))
    mixer = params["blocks"]["l0"]["mixer"]
    dt = rec.softplus(mixer["dt_bias"])
    a = torch.exp(mixer["a_log"])
    assert 1e-3 * (1 - 1e-5) <= dt.min() and dt.max() <= 1e-1 * (1 + 1e-5)
    assert 1 - 1e-5 <= a.min() and a.max() <= 16 * (1 + 1e-5)
    assert dt.std() > 0.02 and a.std() > 3  # spread over the ranges
    assert torch.equal(mixer["d_skip"], torch.ones_like(mixer["d_skip"]))


def test_check_supported_takes_every_mixer_and_frontend_and_refuses_the_softcap():
    base = reduced_config(get_config("qwen3-0.6b"))
    for spec_ in (LayerSpec("mamba2", "none"), LayerSpec("mlstm", "none"),
                  LayerSpec("slstm", "mlp"), LayerSpec("attn_shared", "mlp_shared"),
                  LayerSpec("none", "mlp"), LayerSpec("attn", "none"),
                  LayerSpec("attn_cross", "mlp")):
        check_supported(base.replace(block_pattern=(spec_,), ssm_state=8, ssm_head_dim=16))
    for frontend in ("vision_patches", "audio_frames"):
        check_supported(base.replace(frontend=frontend))
        LM(base.replace(frontend=frontend, num_image_tokens=16), device="cpu")
    with pytest.raises(NotImplementedError, match="softcap"):
        LM(base.replace(attn_logit_softcap=50.0), device="cpu")


# ---------------------------------------------------------------- the model


def _port_cache(jcache: dict) -> dict:
    return convert.lm_cache_from_numpy(to_np(jcache), device="cpu")


def _held(ref: Ref, got: dict, record_property) -> None:
    """Every output in ``got`` of the reference's type: f32 logits and
    cache leaves within ``ref.tol`` of the reference's, the bf16 KV caches
    within one bf16 step (rtol 2^-7 and the f32 atol; an f32 key a last bit
    apart can round to the neighbouring bf16 value) and most values equal,
    the positions exact."""
    worst = {}
    for k, v in got.items():
        want = np.asarray(ref.outputs[k])
        assert str(v.dtype).removeprefix("torch.") == str(want.dtype), k
        if want.dtype == np.float32:
            worst[k] = share(v, want)
            assert worst[k] <= ref.tol, (k, worst[k], ref.tol)
        elif v.dtype == torch.bfloat16:
            a, b = np32(v), np32(want)
            np.testing.assert_allclose(a, b, rtol=2**-7, atol=RTOL * np.abs(b).max(), err_msg=k)
            assert (a == b).mean() > 0.95, k
        else:
            np.testing.assert_array_equal(v.numpy(), want, err_msg=k)
    record_property("worst_share", max(worst.values()))
    record_property("limit", ref.tol)
    record_property("over_move", max(worst.values()) * CONDITIONING / ref.tol)


def test_forward_prefill_and_decode_match_the_reference(ref, record_property):
    """forward's logits; prefill's logits and cache; 4 decode steps from the
    port's own cache, each step's logits and cache."""
    m = LM(ref.cfg, device="cpu")
    p, toks = ref.params, torch.from_numpy(ref.toks)
    got = {"forward": m.forward(p, {"tokens": toks})[0]}
    logits, cache = m.prefill(p, {"tokens": toks}, m.init_cache(2, 32))
    assert logits.shape == (2, 1, ref.cfg.padded_vocab)
    got["prefill"] = logits
    got.update((k, v.clone()) for k, v in cache_leaves(cache))
    for i, (nxt, _, _) in enumerate(ref.decode):
        logits, cache = m.decode_step(p, {"tokens": torch.from_numpy(np.array(nxt))}, cache)
        got[f"decode{i}"] = logits
        got.update((f"decode{i}/{k}", v.clone()) for k, v in cache_leaves(cache))
    assert sorted(got) == sorted(ref.outputs)
    _held(ref, got, record_property)
    assert int(cache["lengths"][0]) == ref.toks.shape[1] + len(ref.decode)


def test_decode_from_the_references_cache(ref, record_property):
    """Each decode step from the reference's own incoming cache: the same
    inputs on both sides; logits and the cache it returns."""
    m = LM(ref.cfg, device="cpu")
    jc, got = ref.prefill_cache, {}
    for i, (nxt, _, jc2) in enumerate(ref.decode):
        logits, cache = m.decode_step(ref.params, {"tokens": torch.from_numpy(np.array(nxt))},
                                      _port_cache(jc))
        got[f"decode{i}"] = logits
        got.update((f"decode{i}/{k}", v) for k, v in cache_leaves(cache))
        jc = jc2
    _held(ref, got, record_property)


def test_each_layer_matches_the_reference_on_its_own_inputs(ref):
    """Training mode, layer by layer along the reference's own hidden states
    (the shared block reading ``params["shared"]``): each within rtol 1e-5,
    so the model-level limit above covers only the stack's conditioning."""
    jcfg, cfg = ref.jcfg, ref.cfg
    h = jtransformer._embed_input(ref.jp, jcfg, {"tokens": jnp.asarray(ref.toks, jnp.int32)})
    blocks = transformer._unstack(ref.params["blocks"], cfg.num_superblocks)
    for sb in range(cfg.num_superblocks):
        for i, layer in enumerate(cfg.block_pattern):
            jl = jax.tree.map(lambda x: x[sb], ref.jp["blocks"][f"l{i}"])
            jh, _, _ = jax.jit(lambda lp, x, s=jcfg.block_pattern[i]: jtransformer._apply_layer(
                lp, ref.jp.get("shared"), x, jcfg, s, mode="train"))(jl, h)
            got, _, _ = transformer._apply_layer(blocks[sb][f"l{i}"], ref.params.get("shared"),
                                                 torch.from_numpy(np.array(h)), cfg, layer,
                                                 mode="train")
            close(got, jh, what=f"superblock {sb} layer {i} {layer.mixer}")
            h = jh


def test_loss_and_every_gradient_match_jax_value_and_grad(ref, record_property):
    jcfg, cfg = ref.jcfg, ref.cfg
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    fn = jax.jit(jax.value_and_grad(jtransformer.loss_fn, has_aux=True), static_argnums=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = fn(ref.jp, jcfg, jb)
    (_, _), nudged = fn(dict(ref.jp, embed=ref.jp["embed"] * (1 + ULP)), jcfg, jb)
    flat = lambda tree: {jax.tree_util.keystr(k): np.asarray(v)
                         for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    jgrads, nudged = flat(jgrads), flat(nudged)
    limit = max(RTOL, CONDITIONING * max(share(nudged[k], v) for k, v in jgrads.items()))
    grads, metrics = grads_of(ref.params, cfg, {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=RTOL)
    port = dict(tree_items(grads))
    assert sorted(port) == sorted(jgrads)
    worst = {key: share(g, jgrads[key]) for key, g in port.items()}
    bad = {k: v for k, v in worst.items() if v > limit}
    assert not bad, (bad, limit)
    record_property("worst_grad_share", max(worst.values()))
    record_property("grad_limit", limit)


def test_decode_state_is_constant_size():
    """The port's twin of ``tests/test_models.py::test_decode_state_is_constant_size``:
    no xlstm leaf grows with the cache length; of zamba2's only the shared
    attention's KV cache does."""
    for arch in ARCHS:
        m = LM(reduced_config(get_config(arch)), device="cpu")
        short, long = (list(cache_leaves(m.init_cache(1, n))) for n in (64, 256))
        grew = [k for (k, a), (_, b) in zip(short, long) if b.numel() > a.numel()]
        if arch == "xlstm-1.3b":
            assert grew == []
        else:
            assert grew and all("/l5/AttnCache" in k for k in grew) and len(grew) < len(short)


# ---------------------------------------------------------------- the traps


def test_lm_cache_from_numpy_keeps_each_layers_cache_type(ref):
    """An MLSTMCache has three leaves, as an AttnCache has; each reference
    NamedTuple converts to the port's of the same name, and a tuple of no
    cache type raises."""
    np_cache = to_np(ref.prefill_cache)
    want = {name: type(c).__name__ for name, c in np_cache["blocks"].items()}
    got = convert.lm_cache_from_numpy(np_cache, device="cpu")
    assert {name: type(c).__name__ for name, c in got["blocks"].items()} == want
    assert "MLSTMCache" in want.values() or "Mamba2Cache" in want.values()
    plain = dict(np_cache, blocks={k: tuple(v) for k, v in np_cache["blocks"].items()})
    with pytest.raises(ValueError, match="no cache type"):
        convert.lm_cache_from_numpy(plain, device="cpu")


def test_index_takes_any_cache_namedtuple():
    """``_index`` keeps a recurrent cache's type and indexes its leaves (an
    ``MLSTMCache`` indexed as a tuple would give its first leaf)."""
    cfg = reduced_config(get_config("xlstm-1.3b"))
    cache = LM(cfg, device="cpu").init_cache(3, 8)
    for sb in range(cfg.num_superblocks):
        picked = transformer._index(cache["blocks"], sb)
        for name, c in cache["blocks"].items():
            assert type(picked[name]) is type(c)
            for leaf, stacked in zip(picked[name], c):
                assert leaf.shape == stacked.shape[1:] and leaf.data_ptr() == stacked[sb].data_ptr()
    assert transformer._index((), 0) == ()


def test_prefill_writes_a_recurrent_state_in_the_references_type():
    """f32 compute returns mamba2's conv state f32 from its bf16 buffer: the
    port's cache takes the f32 leaf, every superblock's rows, as the
    reference's returned cache has it; bf16 compute keeps it bf16."""
    for compute, want in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        cfg = reduced_config(get_config("zamba2-2.7b")).replace(compute_dtype=compute)
        m = LM(cfg, device="cpu")
        cache = m.init_cache(2, 16)
        assert cache["blocks"]["l0"].conv.dtype == torch.bfloat16
        params = m.init(torch.Generator().manual_seed(0))
        _, cache = m.prefill(params, {"tokens": torch.ones((2, 5), dtype=torch.long)}, cache)
        conv = cache["blocks"]["l0"].conv
        assert conv.dtype == want and conv.shape[0] == cfg.num_superblocks
        assert all(conv[sb].abs().sum() > 0 for sb in range(cfg.num_superblocks))


def test_merge_slot_takes_recurrent_caches():
    """Each leaf of each cache NamedTuple merges one slot's rows; a bf16
    leaf whose fresh rows are f32 (mamba2's conv state after an f32 prefill)
    takes the fresh type, the other slots' rows unchanged."""
    cfg = reduced_config(get_config("zamba2-2.7b"))
    m = LM(cfg, device="cpu")
    old, new = m.init_cache(2, 8), m.init_cache(2, 8)
    for cache, value in ((old, 1), (new, 2)):
        for _, leaf in cache_leaves(cache):
            leaf.fill_(value)
    new["blocks"]["l0"] = new["blocks"]["l0"]._replace(conv=new["blocks"]["l0"].conv.float()
                                                       + 2**-10)
    merge_slot(old, new, 1)
    conv = old["blocks"]["l0"].conv
    assert conv.dtype == torch.float32
    assert (conv[:, 1] == 2 + 2**-10).all() and (conv[:, 0] == 1).all()  # not a bf16 value
    for name, leaf in cache_leaves(old):
        if "conv" not in name:
            assert (leaf[:, 1] == 2).all() and (leaf[:, 0] == 1).all(), name


def test_reference_merge_slot_rounds_the_conv_state():
    """The reference caveat the port does not copy (ROADMAP Queue 3): before
    its engine's first decode step the cache's conv leaf is still the bf16
    buffer of ``init_cache``, and ``_merge_slot``'s ``.at[].set`` rounds the
    fresh f32 state of an f32 prefill into it."""
    jcfg = jreduced_config(jget_config("zamba2-2.7b"))
    jm = JLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    toks = jnp.asarray(np.random.default_rng(2).integers(0, 256, (2, 6)), jnp.int32)
    _, fresh = jax.jit(jm.prefill)(jp, {"tokens": toks}, jm.init_cache(2, 16))
    assert fresh["blocks"]["l0"].conv.dtype == jnp.float32
    merged = j_merge_slot(jm.init_cache(2, 16), fresh, 0)
    assert merged["blocks"]["l0"].conv.dtype == jnp.bfloat16
    rows = np.asarray(fresh["blocks"]["l0"].conv[:, 0])
    assert (np32(merged["blocks"]["l0"].conv[:, 0]) != rows).mean() > 0.5


# ---------------------------------------------------------------- serving


def _serve(engine, req, prompts, max_new):
    reqs = [req(rid=i, prompt=p, max_new=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    return [r.out_tokens for r in reqs]


def _greedy_alone(cfg, params, prompt, max_new):
    """The port's single-request greedy run: batch 1, prefill then decode."""
    m = LM(cfg, device="cpu")
    logits, cache = m.prefill(params, {"tokens": torch.as_tensor(prompt)[None]},
                              m.init_cache(1, 64))
    toks = [int(logits[0, -1, :cfg.vocab_size].argmax())]
    for _ in range(max_new - 1):
        logits, cache = m.decode_step(params, {"tokens": torch.tensor([[toks[-1]]])}, cache)
        toks.append(int(logits[0, 0, :cfg.vocab_size].argmax()))
    return toks


def test_engine_matches_the_reference_engine(ref):
    """Three requests over two slots (one admitted after the first decode
    step): the port's engine decodes the reference engine's tokens and each
    request's own batch-1 greedy run."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, ref.cfg.vocab_size, 6 + i) for i in range(3)]
    sc = dict(batch_slots=2, cache_len=64)
    jtoks = _serve(JServeEngine(ref.jcfg, ref.jp, JServeConfig(**sc)), JRequest, prompts, 5)
    eng = ServeEngine(ref.cfg, ref.params, ServeConfig(**sc), device="cpu")
    toks = _serve(eng, Request, prompts, 5)
    assert toks == jtoks
    assert toks == [_greedy_alone(ref.cfg, ref.params, p, 5) for p in prompts]
    assert eng.stats.prefills == 3 and eng.stats.tokens == 15


# ---------------------------------------------------------------- entry points


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs_the_recurrent_archs_on_the_cpu(arch, capsys):
    serve_launcher.main(["--arch", arch, "--device", "cpu", "--requests", "3", "--slots", "2",
                         "--prompt-len", "7", "--max-new", "4", "--cache-len", "32"])
    out = capsys.readouterr().out
    assert "[serve] 3/3 requests on cpu, 12 tokens" in out


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_example_twin_runs_on_the_cpu(arch, capsys):
    main = runpy.run_path(str(EXAMPLE))["main"]
    done = main(["--arch", arch, "--device", "cpu", "--requests", "3", "--slots", "2",
                 "--max-new", "4"])
    assert len(done) == 3 and all(len(r.out_tokens) == 4 for r in done)
    assert "[serve_lm] 3 requests on cpu, 12 tokens" in capsys.readouterr().out
    # the engine's tokens are each request's batch-1 greedy run
    cfg = reduced_config(get_config(arch))
    params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 6 + i % 5) for i in range(3)]
    assert [r.out_tokens for r in sorted(done, key=lambda r: r.rid)] == \
        [_greedy_alone(cfg, params, p, 4) for p in prompts]

