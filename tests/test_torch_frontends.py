"""Cross attention and the stub frontends of the port, against the JAX
package on reduced configs (d 64, 2 superblocks, 16 image tokens):
llama-3.2-vision-90b (4 self + 1 ``attn_cross`` layer a superblock,
``frontend="vision_patches"``) and hubert-xlarge (encoder-only, the full
mask, a gelu MLP, ``frontend="audio_frames"``: no embedding table).

Covered: both configs field by field (``supports_decode``, ``shape_cells``);
specs and weights leaf for leaf; the cross layer (``attn_apply(kind=
"cross")``) in train, prefill and decode on the reference's inputs, with and
without ``use_qk_norm``; the reduced models' forward, loss and every
gradient, prefill and decode with their caches, each layer in the
registered types on the reference's inputs; the caches through
``lm_cache_from_numpy``; a train step with microbatches over ``frames`` and
``vision``; the launch counts ``chip_smoke.py`` derives from the model code;
the serving refusals (``ServeEngine``, ``launch/serve.py``).  Batches come
from a numpy seed: frames and patch embeddings f32 normal, as the
reference's ``tests/test_models.py`` makes them.

Tolerances.  f32 compute: logits, layer outputs and f32 cache leaves rtol
1e-5, atol 1e-5 * max|ref| (the order of the f32 sums and exp differ from
XLA's); the bf16 self-attention KV caches within one bf16 step and mostly
equal (an f32 key a last bit apart can round to the neighbouring bf16
value), positions exact, types equal leaf for leaf; decode from each side's
own cache within 2e-3 of max|logit| (``tests/test_torch_lm.py``'s limit for
the bf16 KV cache).  Gradients: each leaf within ``GRAD_SHARE`` of its
max|grad| of ``jax.value_and_grad``.  Registered types (bf16 compute; llama
on bf16 weights): each layer on the reference's own bf16 inputs, its
outputs equal but at under ``LAYER_FLIP_SHARE`` of them, each of those one
bf16 step apart, as ``tests/test_torch_bf16_weights.py`` holds starcoder2
(the reference compiled with ``xla_allow_excess_precision`` off)."""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist_archs
from repro.configs import reduced_config as jreduced_config
from repro.launch import serve as jserve_launcher
from repro.models import LM as JLM
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.models.spec import init_params as jinit_params
from repro.optim import make_optimizer as jmake_optimizer
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServeEngine as JServeEngine
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch import convert
from repro_torch.common.tree import tree_items
from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import layers, spec, transformer
from repro_torch.models.transformer import LM, model_specs
from repro_torch.optim import make_optimizer
from repro_torch.runtime import record_routes
from repro_torch.serving import ServeConfig, ServeEngine
from repro_torch.train.steps import grads_of, make_train_step
from test_torch_bf16 import bf16_step, exact_jit
from test_torch_hybrid_lm import cache_leaves, close, np32, share
from test_torch_mm_fused_plan import smoke

ARCHS = ["llama-3.2-vision-90b", "hubert-xlarge"]
RTOL = 1e-5
GRAD_SHARE = 1e-5  # tests/test_torch_train.py's limit (it read 1.3e-6 on reduced qwen3 and granite)
OWN_CACHE_TOL = 2e-3
LAYER_FLIP_SHARE = 0.01
B, S, DECODES = 2, 19, 3


@pytest.fixture(autouse=True)
def one_thread():
    """Many small eager ops: one intra-op thread a test runner worker (as
    ``tests/test_torch_train.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def make_batch(cfg, seed: int, b: int = B, s: int = S, labels: bool = False) -> dict:
    """A numpy batch of the arch's inputs: ``frames`` (B, S, d) f32 normal or
    ``tokens``, ``vision`` (B, T, d) f32 normal under ``vision_patches``."""
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.frontend == "audio_frames":
        batch["frames"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    if cfg.frontend == "vision_patches":
        batch["vision"] = rng.standard_normal((b, cfg.num_image_tokens, cfg.d_model)
                                              ).astype(np.float32)
    if labels:
        batch["labels"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return batch


def jbatch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tbatch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def head(batch: dict, stop: int) -> dict:
    """The batch's first ``stop`` positions (the image embeddings whole)."""
    return {k: v if k == "vision" else v[:, :stop] for k, v in batch.items()}


@dataclasses.dataclass
class Ref:
    arch: str
    jcfg: object
    jm: object
    jp: dict
    cfg: object
    params: dict
    batch: dict  # numpy, S positions
    forward: np.ndarray
    prefill: tuple  # (logits, cache) of the first S - DECODES positions (all S for hubert)
    decode: list  # (batch, logits, cache) of each teacher-forced decode step


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    """One reduced arch: the reference's model, weights, forward, prefill and
    teacher-forced decode steps (llama: prefill S - 3, then 3 steps; hubert,
    encoder-only: one prefill of all S frames)."""
    arch = request.param
    jcfg = jreduced_config(jget_config(arch))
    jm = JLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = reduced_config(get_config(arch))
    batch = make_batch(cfg, 1)
    fwd, _ = jax.jit(jm.forward)(jp, jbatch(batch))
    p = S - DECODES if cfg.supports_decode else S
    logits, cache = jax.jit(jm.prefill)(jp, jbatch(head(batch, p)), jm.init_cache(B, 32))
    steps, c = [], cache
    for t in range(p, S if cfg.supports_decode else p):
        step = {k: v if k == "vision" else v[:, t:t + 1] for k, v in batch.items()}
        lg, c = jax.jit(jm.decode_step)(jp, jbatch(step), c)
        steps.append((step, np.asarray(lg), to_np(c)))
    return Ref(arch, jcfg, jm, jp, cfg, convert.lm_params_from_numpy(to_np(jp), device="cpu"),
               batch, np.asarray(fwd), (np.asarray(logits), to_np(cache)), steps)


# ---------------------------------------------------------------- configs, specs, weights


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
                     "supports_decode", "sub_quadratic"):
            assert getattr(port, prop) == getattr(ref_cfg, prop), prop
        assert port.shape_cells() == ref_cfg.shape_cells()
    assert list_archs() == jlist_archs()
    assert get_config(arch).supports_decode == (arch != "hubert-xlarge")


@pytest.mark.parametrize("arch", [a for a in jlist_archs() if a not in ARCHS])
def test_frontend_fields_of_the_other_archs_equal_the_references(arch):
    port, ref_cfg = get_config(arch), jget_config(arch)
    for name in ("is_encoder_only", "frontend", "num_image_tokens", "supports_decode",
                 "sub_quadratic"):
        assert getattr(port, name) == getattr(ref_cfg, name), name
    assert port.shape_cells() == ref_cfg.shape_cells()
    assert reduced_config(port).num_image_tokens == jreduced_config(ref_cfg).num_image_tokens


def test_specs_and_weights_match_the_reference_leaf_for_leaf(ref):
    ref_shapes = jax.tree.map(lambda s: (s.shape, s.init, s.dtype),
                              jtransformer.model_specs(ref.jcfg),
                              is_leaf=lambda x: hasattr(x, "init"))
    assert spec.map_specs(lambda s: (s.shape, s.init, s.dtype), model_specs(ref.cfg)) == ref_shapes
    flat = jax.tree_util.tree_flatten_with_path(to_np(ref.jp))[0]
    assert len(flat) == len(jax.tree.leaves(ref.params))
    for path, leaf in flat:
        got = ref.params
        for key in path:
            got = got[key.key]
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), leaf)
    # hubert reads frames: no embedding table; llama's cross layer has ln_kv
    assert ("embed" in ref.params) == (ref.arch != "hubert-xlarge")
    if ref.arch.startswith("llama"):
        assert sorted(ref.params["blocks"]["l4"]["mixer"]) == ["ln", "ln_kv", "wk", "wo", "wq",
                                                               "wv"]
        assert "ln_kv" not in ref.params["blocks"]["l0"]["mixer"]


def test_lm_cache_from_numpy_takes_the_new_caches(ref):
    """The reference's prefill cache (llama: an f32 cross cache beside the
    bf16 self caches) converts leaf for leaf, types and values equal; an
    empty port cache has the reference's empty cache's leaves and types."""
    jcache = ref.prefill[1]
    port = convert.lm_cache_from_numpy(jcache, device="cpu")
    assert [k for k, _ in cache_leaves(port)] == [k for k, _ in cache_leaves(jcache)]
    for (key, got), (_, want) in zip(cache_leaves(port), cache_leaves(jcache)):
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype), key
        np.testing.assert_array_equal(np32(got), np32(want), err_msg=key)
    empty = LM(ref.cfg, device="cpu").init_cache(B, 32)
    for (key, got), (_, want) in zip(cache_leaves(empty), cache_leaves(ref.jm.init_cache(B, 32))):
        assert tuple(got.shape) == want.shape and str(got.dtype).removeprefix("torch.") == \
            str(want.dtype), key
        np.testing.assert_array_equal(np32(got), np32(want), err_msg=key)
    if ref.arch.startswith("llama"):
        cross = port["blocks"]["l4"]
        assert cross.k.dtype == torch.float32 and cross.k.shape[2] == ref.cfg.num_image_tokens


# ---------------------------------------------------------------- the cross layer


def _cross_case(qk_norm: bool, compute: str):
    cfg = reduced_config(get_config("llama-3.2-vision-90b")).replace(use_qk_norm=qk_norm,
                                                                     compute_dtype=compute)
    jcfg = jreduced_config(jget_config("llama-3.2-vision-90b")).replace(use_qk_norm=qk_norm,
                                                                       compute_dtype=compute)
    jp = jinit_params(jlayers.attn_specs(jcfg, cross=True), jax.random.PRNGKey(3))
    if qk_norm:  # zero-initialised norms would hide which keys are normed
        rng = np.random.default_rng(5)
        jp = dict(jp, **{n: jnp.asarray(rng.standard_normal(cfg.head_dim).astype(np.float32))
                         for n in ("q_norm", "k_norm")})
    rng = np.random.default_rng(4)
    dt = jnp.dtype(compute)
    x = jnp.asarray(rng.standard_normal((B, 7, cfg.d_model)).astype(np.float32), dt)
    x1 = jnp.asarray(rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32), dt)
    vision = jnp.asarray(rng.standard_normal((B, cfg.num_image_tokens, cfg.d_model)
                                             ).astype(np.float32))
    return cfg, jcfg, jp, convert.lm_params_from_numpy(to_np(jp), device="cpu"), x, x1, vision


def _t(a) -> torch.Tensor:
    return convert._tensor(np.asarray(a), torch.device("cpu"))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("qk_norm", [False, True], ids=["plain", "qk_norm"])
def test_cross_layer_matches_the_reference_in_every_mode(qk_norm, compute):
    """``attn_apply(kind="cross")`` on the reference's inputs: training,
    prefill (its cache: the projected image keys and values in the compute
    type, positions 0..T-1) and decode from the reference's prefill cache
    (returned unchanged).  f32: rtol 1e-5; bf16: under
    ``LAYER_FLIP_SHARE`` of the values one bf16 step apart, the rest equal."""
    cfg, jcfg, jp, p, x, x1, vision = _cross_case(qk_norm, compute)

    def held(got, want, what):
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype), what
        if want.dtype == jnp.int32:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=what)
        elif compute == "float32":
            close(got, want, what=what)
        else:
            g, w = np32(got), np32(want)
            assert (np.abs(g - w) <= bf16_step(w) + 1e-6 * np.abs(w).max()).all(), what
            assert float((g != w).mean()) < LAYER_FLIP_SHARE, what

    run = exact_jit(lambda q, h, c, v, mode: jlayers.attn_apply(
        q, h, jcfg, kind="cross", cross_kv=v, cache=c, mode=mode), static_argnames="mode")
    jout, _ = run(jp, x, None, vision, "train")
    out, none = layers.attn_apply(p, _t(x), cfg, kind="cross", cross_kv=_t(vision), mode="train")
    assert none is None
    held(out, jout, "train")
    jout, jcache = run(jp, x, None, vision, "prefill")
    out, cache = layers.attn_apply(p, _t(x), cfg, kind="cross", cross_kv=_t(vision),
                                   mode="prefill")
    held(out, jout, "prefill")
    for field, got, want in zip(cache._fields, cache, jcache):
        held(got, want, f"prefill cache {field}")
    assert cache.k.dtype == getattr(torch, compute)
    ported = layers.AttnCache(*(_t(leaf) for leaf in jcache))
    jout, jcache2 = run(jp, x1, jcache, None, "decode")
    out, cache2 = layers.attn_apply(p, _t(x1), cfg, kind="cross", cache=ported, mode="decode")
    held(out, jout, "decode")
    assert cache2 is ported
    for got, want in zip(cache2, jcache2):
        np.testing.assert_array_equal(np32(got), np32(want))
    if qk_norm and compute == "float32":
        # the reference caveat the port copies (ROADMAP Queue 3): decode
        # attends the cached keys un-normed, prefill the normed ones, so the
        # same query gives another output in decode than in prefill
        pre, _ = layers.attn_apply(p, _t(x1), cfg, kind="cross", cross_kv=_t(vision),
                                   mode="prefill")
        assert share(pre, out) > 1e-3


def test_cross_layer_refuses_a_missing_input():
    cfg, _, _, p, x, x1, vision = _cross_case(False, "float32")
    with pytest.raises(ValueError, match="cross_kv"):
        layers.attn_apply(p, _t(x), cfg, kind="cross", mode="prefill")
    with pytest.raises(ValueError, match="cache"):
        layers.attn_apply(p, _t(x1), cfg, kind="cross", mode="decode")


# ---------------------------------------------------------------- the reduced models


def test_forward_matches_the_reference(ref):
    logits, aux = LM(ref.cfg, device="cpu").forward(ref.params, tbatch(ref.batch))
    assert logits.shape == (B, S, ref.cfg.padded_vocab) and float(aux) == 0.0
    close(logits, ref.forward)


def test_loss_and_every_gradient_match_jax_value_and_grad(ref, record_property):
    batch = make_batch(ref.cfg, 2, labels=True)
    fn = jax.jit(jax.value_and_grad(jtransformer.loss_fn, has_aux=True), static_argnums=1)
    (jloss, _), jgrads = fn(ref.jp, ref.jcfg, jbatch(batch))
    grads, metrics = grads_of(ref.params, ref.cfg, tbatch(batch))
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=RTOL)
    want = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    port = dict(tree_items(grads))
    assert sorted(port) == sorted(want)
    worst = {key: share(g, want[key]) for key, g in port.items()}
    bad = {k: v for k, v in worst.items() if v > GRAD_SHARE}
    assert not bad, bad
    # every leaf learns: the cross layer's k/v and ln_kv through the image rows
    assert all(np.abs(v).max() > 0 for v in want.values())
    record_property("worst_grad_share", max(worst.values()))


def _held_cache(got: dict, want: dict, what: str) -> None:
    """Every leaf of a port cache against the reference's: types equal, f32
    within rtol 1e-5, the bf16 KV caches within one bf16 step and mostly
    equal, positions exact."""
    keys = [k for k, _ in cache_leaves(want)]
    assert [k for k, _ in cache_leaves(got)] == keys
    for (key, g), (_, w) in zip(cache_leaves(got), cache_leaves(want)):
        w = np.asarray(w)
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), (what, key)
        if w.dtype == np.float32:
            close(g, w, what=f"{what} {key}")
        elif g.dtype == torch.bfloat16:
            a, b = np32(g), np32(w)
            np.testing.assert_allclose(a, b, rtol=2**-7, atol=RTOL * np.abs(b).max(),
                                       err_msg=f"{what} {key}")
            assert (a == b).mean() > 0.95, (what, key)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{what} {key}")


def _held_decode_cache(got: dict, want: dict, position: int, what: str) -> bool:
    """A decode step's cache against the reference's, from the same incoming
    cache: types equal; every leaf bit for bit but the self-attention keys
    and values written at ``position``, each within one bf16 step at its
    leaf's largest value (an f32 key a last bit apart, or one after such a
    rounding upstream, can round to another bf16 value).  Returns whether
    those writes equal the reference's too."""
    alike = True
    assert np.array_equal(got["lengths"].numpy(), np.asarray(want["lengths"])), what
    for (key, g), (_, w) in zip(cache_leaves(got), cache_leaves(want)):
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), (what, key)
        kv = g.dtype == torch.bfloat16  # (L, B, C, Hkv, D): the self-attention caches
        g, w = np32(g), np32(w)
        if kv and not np.array_equal(g[:, :, position], w[:, :, position]):
            assert (np.abs(g - w) <= bf16_step(np.abs(w).max())).all(), (what, key)
            g[:, :, position] = w[:, :, position]
            alike = False
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {key}")
    return alike


def test_prefill_and_decode_match_the_reference(ref, record_property):
    """The prefill's logits and cache; each decode step from the reference's
    own incoming cache: rtol 1e-5 where every bf16 key and value the step
    wrote equals the reference's, else within ``OWN_CACHE_TOL`` (an f32 key
    a last bit apart rounded to the neighbouring bf16 value: reduced llama's
    third step rounds 8 of its new entries apart, and its logits move 1.2e-4
    of max|logit|; ``test_each_layer_decodes_as_the_reference`` holds each
    layer's writes bit for bit on the reference's inputs); from the port's
    own cache within ``OWN_CACHE_TOL``; the cross cache is the prefill's
    projected image rows, unchanged by decode; decode with or without the
    batch's ``vision`` the same."""
    m = LM(ref.cfg, device="cpu")
    p = S - DECODES if ref.cfg.supports_decode else S
    logits, cache = m.prefill(ref.params, tbatch(head(ref.batch, p)), m.init_cache(B, 32))
    assert logits.shape == (B, 1, ref.cfg.padded_vocab)
    close(logits, ref.prefill[0])
    _held_cache({k: v for k, v in cache.items()}, ref.prefill[1], "prefill")
    assert int(cache["lengths"][0]) == p
    own, worst, exact, own_logits = cache, 0.0, 0, []
    for i, (step, jlogits, jcache) in enumerate(ref.decode):
        incoming = ref.prefill[1] if i == 0 else ref.decode[i - 1][2]
        got, c = m.decode_step(ref.params, tbatch(step),
                               convert.lm_cache_from_numpy(incoming, device="cpu"))
        if _held_decode_cache(c, jcache, p + i, f"decode {i}"):
            close(got, jlogits)
            exact += 1
        else:
            assert share(got, jlogits) <= OWN_CACHE_TOL, i
        cross_k = own["blocks"]["l4"].k.clone()
        got_own, own = m.decode_step(ref.params, tbatch(step), own)
        own_logits.append(got_own)
        worst = max(worst, share(got_own, jlogits))
        assert torch.equal(own["blocks"]["l4"].k, cross_k)
        without, _ = m.decode_step(ref.params, tbatch({"tokens": step["tokens"]}),
                                   convert.lm_cache_from_numpy(incoming, device="cpu"))
        assert torch.equal(without, got)
    assert worst <= OWN_CACHE_TOL, worst
    assert exact or not ref.decode  # the rule at rtol 1e-5 is not left unused
    record_property("own_cache_worst_share", worst)
    record_property("decode_steps_at_rtol", exact)
    if ref.cfg.supports_decode:  # the port's teacher-forced decode against its own forward,
        # by the reference's tests/test_consistency.py rule (2e-2, absolute)
        fwd, _ = m.forward(ref.params, tbatch(ref.batch))
        for i, step_logits in enumerate(own_logits):
            assert (step_logits[:, 0] - fwd[:, p + i]).abs().max() < 2e-2, i
    else:  # bidirectional: the prefill's last position is the forward's
        close(logits[:, 0], ref.forward[:, -1])


def test_qk_norm_decode_matches_the_reference():
    """Reduced llama-vision with ``use_qk_norm``: the port's decode equals
    the reference's, which attends the un-normed cached cross keys (ROADMAP
    Queue 3), from the same incoming cache (rtol 1e-5)."""
    jcfg = jreduced_config(jget_config("llama-3.2-vision-90b")).replace(use_qk_norm=True)
    cfg = reduced_config(get_config("llama-3.2-vision-90b")).replace(use_qk_norm=True)
    jm = JLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(2))
    rng = np.random.default_rng(6)
    jp = jax.tree_util.tree_map_with_path(  # the norms drawn, not zero: which keys are normed shows

        lambda path, v: (jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.5)
                         if "norm" in jax.tree_util.keystr(path) else v), jp)
    params = convert.lm_params_from_numpy(to_np(jp), device="cpu")
    batch = make_batch(cfg, 7)
    _, jc = jax.jit(jm.prefill)(jp, jbatch(head(batch, S - 1)), jm.init_cache(B, 32))
    step = {k: v if k == "vision" else v[:, S - 1:] for k, v in batch.items()}
    jl, jc2 = jax.jit(jm.decode_step)(jp, jbatch(step), jc)
    m = LM(cfg, device="cpu")
    got, c2 = m.decode_step(params, tbatch(step), convert.lm_cache_from_numpy(to_np(jc),
                                                                             device="cpu"))
    close(got, jl)
    _held_cache(c2, to_np(jc2), "qk-norm decode")


def _parts(cfg, spec_):
    """The mixer and the FFN of a layer in training mode as the reference's
    and the port's functions of (params, x, cross_kv, cfg), each returning
    the new hidden state first."""
    kind = "cross" if spec_.mixer == "attn_cross" else ("causal" if cfg.causal else "full")
    return {"mixer": (lambda q, x, v, c: jlayers.attn_apply(q, x, c, kind=kind, cross_kv=v),
                      lambda q, x, v, c: layers.attn_apply(q, x, c, kind=kind, cross_kv=v)),
            "ffn": (lambda q, x, v, c: (jlayers.mlp_apply(q, x, c), None),
                    lambda q, x, v, c: (layers.mlp_apply(q, x, c), None))}


def test_each_layer_in_the_registered_types_matches_the_reference(ref, record_property):
    """The registered types (bf16 compute; llama on bf16 weights, hubert on
    f32): the attention and the MLP of each layer, each fed the reference's
    own input (and the bf16 image embeddings), its outputs equal the
    reference's but at under ``LAYER_FLIP_SHARE`` of them, and those within
    one bf16 step at the part's largest output.  (An intermediate bf16 value,
    the attention output or the gated product, that rounds apart moves a
    small output by a few of its own steps: 4 at most read, 6.9e-05 of
    max|out|.)"""
    reg = get_config(ref.arch)
    kw = dict(param_dtype=reg.param_dtype, compute_dtype=reg.compute_dtype)
    jcfg, cfg = ref.jcfg.replace(**kw), ref.cfg.replace(**kw)
    jp = jax.tree.map(lambda v: v.astype(jnp.dtype(reg.param_dtype)), ref.jp)
    params = convert.lm_params_from_numpy(to_np(jp), device="cpu")
    batch = make_batch(cfg, 3)
    jvision = vision = None
    if "vision" in batch:
        jvision = jnp.asarray(batch["vision"], jnp.bfloat16)
        vision = _t(jvision)
    h = exact_jit(lambda q, b: jtransformer._embed_input(q, jcfg, b))(jp, jbatch(batch))
    shares, compiled = [], {}  # one reference compile a (mixer, part)
    for sb in range(cfg.num_superblocks):
        for i, layer in enumerate(cfg.block_pattern):
            for part, (ref_fn, port_fn) in _parts(cfg, layer).items():
                jq = jax.tree.map(lambda a: a[sb], jp["blocks"][f"l{i}"][part])
                q = {name: leaf[sb] for name, leaf in params["blocks"][f"l{i}"][part].items()}
                x = _t(h)
                if (layer.mixer, part) not in compiled:
                    compiled[layer.mixer, part] = exact_jit(
                        lambda q, x, v, f=ref_fn: f(q, x, v, jcfg)[0])
                h = compiled[layer.mixer, part](jq, h, jvision)
                got = port_fn(q, x, vision, cfg)[0]
                want = np32(h)
                assert got.dtype == torch.bfloat16 and h.dtype == jnp.bfloat16
                diff = np.abs(np32(got) - want)
                where = (sb, i, layer.mixer, part)
                assert (diff <= bf16_step(np.abs(want).max())).all(), where
                shares.append(float((diff > 0).mean()))
                assert shares[-1] < LAYER_FLIP_SHARE, (where, shares[-1])
    record_property("share_differing_per_part", shares)


def test_each_layer_decodes_as_the_reference():
    """Reduced llama-vision's last decode step layer by layer, each layer
    fed the reference's own hidden state and incoming cache: outputs within
    rtol 1e-5, and every cache entry it writes (the self layers' bf16 keys
    and values; the cross layers write none) equal to the reference's bit
    for bit."""
    arch = "llama-3.2-vision-90b"
    jcfg, cfg = jreduced_config(jget_config(arch)), reduced_config(get_config(arch))
    jm = JLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    params = convert.lm_params_from_numpy(to_np(jp), device="cpu")
    batch = make_batch(cfg, 1)
    _, c = jax.jit(jm.prefill)(jp, jbatch(head(batch, S - 1)), jm.init_cache(B, 32))
    step = {k: v if k == "vision" else v[:, S - 1:] for k, v in batch.items()}
    port_cache = convert.lm_cache_from_numpy(to_np(c), device="cpu")
    lengths = c["lengths"]
    h = jtransformer._embed_input(jp, jcfg, jbatch(step))
    blocks = transformer._unstack(params["blocks"], cfg.num_superblocks)
    compiled = {}  # one reference compile a mixer
    for sb in range(cfg.num_superblocks):
        for i, layer in enumerate(cfg.block_pattern):
            jl = jax.tree.map(lambda x: x[sb], jp["blocks"][f"l{i}"])
            jc = jax.tree.map(lambda x: x[sb], c["blocks"][f"l{i}"])
            x = _t(h)
            if layer.mixer not in compiled:
                compiled[layer.mixer] = jax.jit(lambda lp, x, cc, s=jcfg.block_pattern[i]:
                                                jtransformer._apply_layer(
                                                    lp, None, x, jcfg, s, mode="decode",
                                                    cache=cc, lengths=lengths))
            h, jnew, _ = compiled[layer.mixer](jl, h, jc)
            got, new, _ = transformer._apply_layer(
                blocks[sb][f"l{i}"], None, x, cfg, layer, mode="decode",
                cache=transformer._index(port_cache["blocks"], sb)[f"l{i}"],
                lengths=port_cache["lengths"])
            close(got, h, what=f"superblock {sb} layer {i}")
            for field, a, b in zip(new._fields, new, jnew):
                assert str(a.dtype).removeprefix("torch.") == str(b.dtype), field
                np.testing.assert_array_equal(np32(a), np32(b), err_msg=f"{sb} {i} {field}")


def test_train_step_splits_frames_and_vision_into_microbatches(ref):
    """``make_train_step`` with 2 microbatches over a batch of ``frames`` or
    ``tokens`` and ``vision``: the loss and gradient norm within rtol 1e-5 of
    the reference's step (SGD, the same split), the updated parameters
    within rtol 1e-5 (SGD: the update is linear in the gradient)."""
    batch = make_batch(ref.cfg, 8, b=4, s=8, labels=True)
    jopt = jmake_optimizer("sgd", 0.1)
    jstep = jax.jit(jmake_train_step(ref.jcfg, jopt, accum_steps=2))
    jparams, _, jmetrics = jstep(ref.jp, jopt.init(ref.jp), jnp.asarray(0, jnp.int32),
                                 jbatch(batch))
    opt = make_optimizer("sgd", 0.1)
    params = convert.lm_params_from_numpy(to_np(ref.jp), device="cpu")
    state = opt.init(params)
    params, _, metrics = make_train_step(ref.cfg, opt, accum_steps=2)(params, state, 0,
                                                                    tbatch(batch))
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=RTOL,
                                   err_msg=key)
    want = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    for key, got in tree_items(params):
        close(got, want[key], what=key)


# ---------------------------------------------------------------- chip_smoke's launch counts


@pytest.mark.parametrize("arch", ARCHS + ["qwen3-0.6b", "zamba2-2.7b", "granite-moe-1b-a400m"])
def test_smoke_counts_the_routed_matmuls_of_each_mode(arch):
    """``chip_smoke.layer_matmuls``/``lm_forward_matmuls`` against the matmuls
    a reduced model records: a forward, a prefill and (but hubert) a decode
    step, as (k, n) multisets; the cross layer decodes with q and o only."""
    cfg = reduced_config(get_config(arch)).replace(router_policy="arype_only")
    m = LM(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    batch = tbatch(make_batch(cfg, 9, s=5))

    def recorded(fn):
        with record_routes() as routes:
            fn()
        return sorted((r.k, r.n) for r in routes)

    def counted(decode):
        return sorted((k, n) for _, k, n in smoke.lm_forward_matmuls(cfg, decode=decode))

    assert recorded(lambda: m.forward(params, batch)) == counted(False)
    cache = m.init_cache(B, 16)
    assert recorded(lambda: m.prefill(params, batch, cache)) == counted(False)
    if cfg.supports_decode:
        step = {k: v if k == "vision" else v[:, :1] for k, v in batch.items()}
        assert recorded(lambda: m.decode_step(params, step, cache)) == counted(True)
    assert smoke.attention_layers(cfg) == sum(
        layer.mixer in ("attn", "attn_local", "attn_shared", "attn_cross")
        for layer in cfg.all_layers())


def test_smoke_counts_the_full_configs_as_the_issue_states():
    llama = get_config("llama-3.2-vision-90b").replace(num_superblocks=2)
    assert len(smoke.lm_forward_matmuls(llama)) == 71
    assert len(smoke.lm_forward_matmuls(llama, decode=True)) == 67
    hubert = get_config("hubert-xlarge")
    assert len(smoke.lm_forward_matmuls(hubert)) == 289
    assert smoke.attention_layers(hubert) == 48 and smoke.attention_layers(llama) == 10


# ---------------------------------------------------------------- serving


@pytest.mark.parametrize("arch,match", [("hubert-xlarge", "encoder-only"),
                                        ("llama-3.2-vision-90b", "vision_patches")])
def test_serve_engine_refuses_what_a_token_request_cannot_feed(arch, match):
    cfg = reduced_config(get_config(arch))
    with pytest.raises(NotImplementedError, match=match):
        ServeEngine(cfg, {}, ServeConfig(batch_slots=2, cache_len=32), device="cpu")


@pytest.mark.parametrize("arch,error", [("hubert-xlarge", KeyError),
                                        ("llama-3.2-vision-90b", (AttributeError, TypeError))])
def test_reference_engine_fails_inside_its_prefill(arch, error):
    """The reference caveat behind the refusals (ROADMAP Queue 3): its engine
    takes these configs and fails at its first prefill, which reads
    ``frames`` (hubert) or norms the missing image embeddings (llama)."""
    jcfg = jreduced_config(jget_config(arch))
    jm = JLM(jcfg)
    eng = JServeEngine(jcfg, jm.init(jax.random.PRNGKey(0)),
                       JServeConfig(batch_slots=2, cache_len=32))
    eng.submit(JRequest(rid=0, prompt=np.arange(4), max_new=2))
    with pytest.raises(error):
        eng.step()


def test_serve_launcher_exits_for_an_encoder_only_arch_as_the_reference(monkeypatch):
    with pytest.raises(SystemExit) as port:
        serve_launcher.main(["--arch", "hubert-xlarge", "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "hubert-xlarge"])
    with pytest.raises(SystemExit) as reference:
        jserve_launcher.main()
    assert str(port.value) == str(reference.value) == "hubert-xlarge is encoder-only; no decode path"
