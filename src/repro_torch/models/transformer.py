"""The LM assembly of the port (the reference's ``models/transformer.py``):
embed -> head layers -> superblocks -> tail layers -> final norm -> lm head,
with the training forward and loss, prefill and decode entry points.

The superblocks' parameters and caches stay stacked on a leading axis, as the
reference lays them out for its ``lax.scan``; the port loops over them.  The
port runs attention (``attn``, ``attn_local``), the recurrent mixers
(``mamba2``, ``mlstm``, ``slstm``: ``models/recurrent.py``) and zamba2's
shared block (``attn_shared`` with ``mlp_shared``: one attention and one MLP
stored once in ``params["shared"]``, each occurrence with its own KV cache),
cross attention (``attn_cross``: keys and values from the batch's
``vision`` embeddings, cached at prefill), with the dense MLP, the mixture
of experts (``moe``) or no FFN (``none``), on f32 or bf16 weights in f32 or
bf16 compute (the registered configs' default: bf16 activations, each
routed matmul summed in f32 and rounded once).  The modality frontends are
the reference's stubs: ``audio_frames`` reads precomputed frame embeddings
(``batch["frames"]``, no embedding table), ``vision_patches`` adds patch
embeddings (``batch["vision"]``) that every cross-attention layer attends.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common.util import Device, resolve_device
from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.core import router
from repro_torch.models import recurrent as rec
from repro_torch.models import spec as pspec
from repro_torch.models.layers import (
    AttnCache,
    attn_apply,
    attn_specs,
    init_attn_cache,
    mlp_apply,
    mlp_specs,
    moe_apply,
    moe_specs,
    rms_norm,
)
from repro_torch.models.spec import ParamSpec
from repro_torch.runtime import RuntimeConfig

# the attention kind of each attention mixer (a shared block attends causally)
_ATTN_KIND = {"attn": "causal", "attn_local": "local", "attn_shared": "causal",
              "attn_cross": "cross"}
# each recurrent mixer's (specs, apply, empty cache)
_RECURRENT = {"mamba2": (rec.mamba2_specs, rec.mamba2_apply, rec.init_mamba2_cache),
              "mlstm": (rec.mlstm_specs, rec.mlstm_apply, rec.init_mlstm_cache),
              "slstm": (rec.slstm_specs, rec.slstm_apply, rec.init_slstm_cache)}
# each mixer's cache type (the empty tuple for none)
CACHE_TYPES = {**dict.fromkeys(_ATTN_KIND, AttnCache), "mamba2": rec.Mamba2Cache,
               "mlstm": rec.MLSTMCache, "slstm": rec.SLSTMCache, "none": tuple}


def check_supported(cfg: ArchConfig) -> None:
    """Refuse what the port does not run: types other than f32 and bf16, and
    the attention logit softcap.  (Every mixer and FFN kind ``LayerSpec``
    accepts runs.)"""
    for field in ("compute_dtype", "param_dtype"):
        if getattr(cfg, field) not in ("float32", "bfloat16"):
            raise NotImplementedError(f"{cfg.name}: {field} {getattr(cfg, field)!r} is not "
                                      "ported (float32 and bfloat16 are)")
    if cfg.attn_logit_softcap != 0:
        raise NotImplementedError(f"{cfg.name}: attn_logit_softcap is not ported")


# ---------------------------------------------------------------- specs, caches


def layer_specs(cfg: ArchConfig, spec: LayerSpec, *, d_ff_override: Optional[int] = None
                ) -> dict:
    """A layer's own parameters: its mixer's (none for a shared or absent
    mixer) and its FFN's (the MLP ``d_ff_override`` wide, or the MoE; none
    for a shared or absent FFN)."""
    if spec.mixer in ("attn", "attn_local", "attn_cross"):
        mixer = attn_specs(cfg, cross=spec.mixer == "attn_cross")
    elif spec.mixer in _RECURRENT:
        mixer = _RECURRENT[spec.mixer][0](cfg)
    else:  # attn_shared, none: in the shared group, or nothing
        mixer = {}
    if spec.ffn == "mlp":
        ffn = mlp_specs(cfg, d_ff_override)
    elif spec.ffn == "moe":
        ffn = moe_specs(cfg)
    else:  # mlp_shared, none
        ffn = {}
    return {"mixer": mixer, "ffn": ffn}


def _uses_shared(cfg: ArchConfig) -> bool:
    return any(l.mixer == "attn_shared" or l.ffn == "mlp_shared" for l in cfg.all_layers())


def model_specs(cfg: ArchConfig) -> dict:
    check_supported(cfg)
    dt = cfg.param_dtype
    d, v = cfg.d_model, cfg.padded_vocab
    specs: dict = {}
    if cfg.frontend != "audio_frames":  # frames arrive embedded: no table
        specs["embed"] = ParamSpec((v, d), ("vocab", "embed"), "small_normal", dtype=dt)
    for i, s in enumerate(cfg.head_pattern):
        specs[f"pre{i}"] = layer_specs(cfg, s, d_ff_override=cfg.first_dense_ff or None)
    superblock = {f"l{i}": layer_specs(cfg, s) for i, s in enumerate(cfg.block_pattern)}
    specs["blocks"] = pspec.stack_specs(superblock, cfg.num_superblocks)
    for i, s in enumerate(cfg.tail_pattern):
        specs[f"tail{i}"] = layer_specs(cfg, s)
    if _uses_shared(cfg):  # zamba2: one attention and one MLP, reused by every occurrence
        specs["shared"] = {"mixer": attn_specs(cfg), "ffn": mlp_specs(cfg)}
    specs["final_norm"] = ParamSpec((d,), ("embed",), "zeros", dtype=dt)
    specs["lm_head"] = ParamSpec((d, v), ("embed", "vocab"), "small_normal", dtype=dt)
    return specs


def _layer_cache(cfg: ArchConfig, spec: LayerSpec, batch: int, cache_len: int,
                 dev: torch.device) -> Any:
    """A layer's empty cache: an :class:`AttnCache` for an attention mixer
    (a shared one's too: each occurrence keeps its own keys and values; a
    cross one's holds ``num_image_tokens`` rows, bf16 zeros at positions 0,
    as the reference's, until its prefill writes the projected embeddings),
    the recurrent state of a recurrent one, ``()`` for none."""
    if spec.mixer == "attn_cross":
        shape = (batch, max(cfg.num_image_tokens, 1), cfg.num_kv_heads, cfg.head_dim)
        return AttnCache(k=torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                         v=torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                         pos=torch.zeros(shape[:2], dtype=torch.int32, device=dev))
    if spec.mixer in _ATTN_KIND:
        return init_attn_cache(cfg, batch, cache_len, kind=_ATTN_KIND[spec.mixer], device=dev)
    if spec.mixer in _RECURRENT:
        return _RECURRENT[spec.mixer][2](cfg, batch, device=dev)
    return ()


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, *, device: Device = None) -> dict:
    """Empty caches: ``blocks`` holds one cache NamedTuple (``AttnCache``,
    ``Mamba2Cache``, ``MLSTMCache``, ``SLSTMCache``) per superblock layer
    with every leaf stacked over the superblocks (batch on axis 1), the head
    and tail layers one each (batch on axis 0), ``lengths`` (B,) int32."""
    check_supported(cfg)
    dev = resolve_device(device)

    def stacked(c: Any) -> Any:
        return type(c)(*(torch.stack([leaf] * cfg.num_superblocks) for leaf in c))

    cache: dict = {
        "blocks": {f"l{i}": stacked(_layer_cache(cfg, s, batch, cache_len, dev))
                   for i, s in enumerate(cfg.block_pattern)},
        "lengths": torch.zeros(batch, dtype=torch.int32, device=dev),
    }
    for i, s in enumerate(cfg.head_pattern):
        cache[f"pre{i}"] = _layer_cache(cfg, s, batch, cache_len, dev)
    for i, s in enumerate(cfg.tail_pattern):
        cache[f"tail{i}"] = _layer_cache(cfg, s, batch, cache_len, dev)
    return cache


# ---------------------------------------------------------------- layers


def _apply_layer(lp: dict, shared: Optional[dict], h: torch.Tensor, cfg: ArchConfig,
                 spec: LayerSpec, *, mode: str, cache: Any = None,
                 lengths: Optional[torch.Tensor] = None,
                 cross_kv: Optional[torch.Tensor] = None):
    """Returns (h, the layer's cache, aux): the mixer, then the FFN (aux the
    MoE's load-balance loss; 0.0 otherwise, a float: no kernel).  A shared
    mixer or MLP runs ``shared``'s weights; a cross-attention mixer attends
    ``cross_kv``.  A self-attention mixer writes its cache in place and
    returns it; a recurrent one, and a cross one at prefill, return a new
    cache (None in training) for the caller to store."""
    m = spec.mixer
    cache = cache if cache != () else None
    if m in _ATTN_KIND:
        kind = _ATTN_KIND[m]
        if kind == "causal" and not cfg.causal:
            kind = "full"
        p_attn = shared["mixer"] if m == "attn_shared" else lp["mixer"]
        h, cache = attn_apply(p_attn, h, cfg, kind=kind, cross_kv=cross_kv, cache=cache,
                              lengths=lengths, mode=mode)
    elif m in _RECURRENT:
        h, cache = _RECURRENT[m][1](lp["mixer"], h, cfg, mode=mode, cache=cache)
    if spec.ffn == "moe":
        h, aux = moe_apply(lp["ffn"], h, cfg)
        return h, cache, aux
    if spec.ffn in ("mlp", "mlp_shared"):
        h = mlp_apply(shared["ffn"] if spec.ffn == "mlp_shared" else lp["ffn"], h, cfg)
    return h, cache, 0.0


def _index(tree: Any, i: int) -> Any:
    """Superblock ``i`` of a stacked tree (views: writes reach the stack).
    A cache NamedTuple of any kind keeps its type, its leaves indexed."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):  # AttnCache, Mamba2Cache, MLSTMCache, SLSTMCache, ()
        return type(tree)(*(leaf[i] for leaf in tree))
    return tree[i]


def store_rows(old: tuple, rows, index) -> tuple:
    """``old`` (a cache NamedTuple) with ``rows`` written into each leaf at
    ``index``, in place.  A leaf takes its rows' type, as the reference's
    returned cache does: mamba2's bf16 conv buffer comes back f32 from f32
    compute, so that leaf is first replaced by an f32 copy (its other rows
    exactly).  Returns the NamedTuple of the leaves written."""
    leaves = []
    for leaf, new in zip(old, rows):
        if leaf.dtype != new.dtype:
            leaf = leaf.to(new.dtype)
        leaf[index] = new
        leaves.append(leaf)
    return type(old)(*leaves)


def _unstack(tree: dict, n: int) -> list:
    """The ``n`` superblocks of a stacked parameter tree, each leaf unbound
    once (views; under autograd each stacked leaf's gradient is then one
    stack of its superblocks' gradients, not ``n`` full-size scatters)."""
    flat = {k: _unstack(v, n) if isinstance(v, dict) else torch.unbind(v)
            for k, v in tree.items()}
    return [{k: v[i] for k, v in flat.items()} for i in range(n)]


def _layers(params: dict, cfg: ArchConfig, h: torch.Tensor, *, mode: str,
            cache: Optional[dict] = None,
            cross_kv: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, Any]:
    """Every layer in order: head, the superblocks (a loop in place of the
    reference's scan), tail; every cross-attention layer attends
    ``cross_kv``.  Caches are written in place (a recurrent layer's state
    and a cross layer's prefill keys by :func:`store_rows`, each leaf in
    the type the layer returns).  Returns (h, the summed aux
    loss: an f32 tensor, or 0.0 without MoE layers), summed in the
    reference's order: head layers, each superblock's sum, tail layers."""
    lengths = cache["lengths"] if cache is not None else None
    shared = params.get("shared")

    def run(h, lp, spec, key, caches, sb=None):
        c = None
        if caches is not None:
            c = _index(caches[key], sb) if sb is not None else caches[key]
        h, new, aux = _apply_layer(lp[key], shared, h, cfg, spec, mode=mode, cache=c,
                                   lengths=lengths, cross_kv=cross_kv)
        if caches is not None and (spec.mixer in _RECURRENT or (
                spec.mixer == "attn_cross" and mode == "prefill")):  # a new cache: store it
            caches[key] = store_rows(caches[key], new, sb if sb is not None else slice(None))
        return h, aux

    aux_total = 0.0
    for i, spec in enumerate(cfg.head_pattern):
        h, aux = run(h, params, spec, f"pre{i}", cache)
        aux_total = aux_total + aux
    blocks = _unstack(params["blocks"], cfg.num_superblocks)
    for sb in range(cfg.num_superblocks):
        sb_aux = 0.0
        for i, spec in enumerate(cfg.block_pattern):
            h, aux = run(h, blocks[sb], spec, f"l{i}",
                         cache["blocks"] if cache is not None else None, sb)
            sb_aux = sb_aux + aux
        aux_total = aux_total + sb_aux
    for i, spec in enumerate(cfg.tail_pattern):
        h, aux = run(h, params, spec, f"tail{i}", cache)
        aux_total = aux_total + aux
    return h, aux_total


# ---------------------------------------------------------------- forward passes


def _embed_input(params: dict, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """The embedding rows in the compute dtype, or under ``audio_frames`` the
    batch's ``frames`` (B, S, d_model) cast to it.  The reference scales the
    rows by a numpy f32 scalar, which JAX types strongly: a bf16 row times it
    is f32, so under ``embed_scale`` (gemma3) the stack runs in f32 after one
    bf16 rounding of the embedding, and the port does the same."""
    if cfg.frontend == "audio_frames":
        return batch["frames"].to(getattr(torch, cfg.compute_dtype))
    # F.embedding: its backward sums each row's gradients deterministically
    # on the card, where indexing's would scatter-add them
    h = F.embedding(batch["tokens"].long(), params["embed"]).to(getattr(torch, cfg.compute_dtype))
    if cfg.embed_scale:
        h = h.float() * float(np.float32(np.sqrt(cfg.d_model)))
    return h


def _logits(params: dict, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"])
    logits = router.matmul(h, params["lm_head"], out_dtype=torch.float32,
                           config=RuntimeConfig.from_arch(cfg), name="lm_head")
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=h.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits


def forward_train(params: dict, cfg: ArchConfig, batch: dict
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (logits (B, S, V) f32, the MoE layers' summed aux loss, an f32
    scalar: 0 without MoE layers).  Differentiable: with parameters that
    require grad, every routed matmul and the attention carry their
    backward (``router.EngineMatmul``, ``layers.TrainAttention``), and the
    MoE's aux (an f32 tensor) keeps its graph.  Nothing here waits for the
    device."""
    check_supported(cfg)
    h, aux = _layers(params, cfg, _embed_input(params, cfg, batch), mode="train",
                     cross_kv=batch.get("vision"))
    if not isinstance(aux, torch.Tensor):  # no MoE layer: a zero made on the device, no copy
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return _logits(params, cfg, h), aux


forward = forward_train  # the serving tests' name


def loss_fn(params: dict, cfg: ArchConfig, batch: dict) -> tuple[torch.Tensor, dict]:
    """The reference's loss: mean cross entropy of ``batch["labels"]`` (the
    logsumexp minus the gold logit) plus ``router_aux_weight`` times the aux
    loss.  Returns (loss, {"ce", "aux", "loss"}), each a 0-d f32 tensor."""
    logits, aux = forward_train(params, cfg, batch)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["labels"].long()[..., None])[..., 0]
    ce = (lse - gold).mean()
    loss = ce + cfg.router_aux_weight * aux
    return loss, {"ce": ce, "aux": aux, "loss": loss}


def _forward_cached(params: dict, cfg: ArchConfig, batch: dict, cache: dict, mode: str):
    check_supported(cfg)
    h = _embed_input(params, cfg, batch)
    h, _ = _layers(params, cfg, h, mode=mode, cache=cache,  # the aux dropped, as the reference's
                   cross_kv=batch.get("vision"))
    new_cache = dict(cache, lengths=cache["lengths"] + h.shape[1])
    return _logits(params, cfg, h[:, -1:, :]), new_cache  # the last position's logits


def prefill(params: dict, cfg: ArchConfig, batch: dict, cache: dict):
    """Fill the cache from a prompt batch ``{"tokens": (B, P)}`` (``frames``
    (B, P, d_model) under ``audio_frames``; with ``vision`` (B, T, d_model)
    under ``vision_patches``); returns (last-position logits (B, 1, V), the
    cache).  The cache's tensors are written in place; ``lengths`` grows by
    P for every row."""
    return _forward_cached(params, cfg, batch, cache, "prefill")


def decode_step(params: dict, cfg: ArchConfig, batch: dict, cache: dict):
    """One decode step: ``batch["tokens"]`` is (B, 1).  A cross-attention
    layer attends the keys its prefill cached, so ``vision`` may be left
    out."""
    return _forward_cached(params, cfg, batch, cache, "decode")


class LM:
    """The model facade: a config and the device its tensors live on (the
    card unless the caller names another)."""

    def __init__(self, cfg: ArchConfig, *, device: Device = None):
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)

    def specs(self) -> dict:
        return model_specs(self.cfg)

    def init(self, generator: torch.Generator) -> dict:
        return pspec.init_params(self.specs(), generator, device=self.device)

    def abstract_params(self) -> dict:
        return pspec.abstract_params(self.specs())

    def init_cache(self, batch: int, cache_len: int) -> dict:
        return init_cache(self.cfg, batch, cache_len, device=self.device)

    def loss(self, params: dict, batch: dict):
        return loss_fn(params, self.cfg, batch)

    def forward(self, params: dict, batch: dict):
        return forward_train(params, self.cfg, batch)

    def prefill(self, params: dict, batch: dict, cache: dict):
        return prefill(params, self.cfg, batch, cache)

    def decode_step(self, params: dict, batch: dict, cache: dict):
        return decode_step(params, self.cfg, batch, cache)
