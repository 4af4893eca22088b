"""The LM assembly of the port (the reference's ``models/transformer.py``):
embed -> head layers -> superblocks -> tail layers -> final norm -> lm head,
with forward, prefill and decode entry points.

The superblocks' parameters and caches stay stacked on a leading axis, as the
reference lays them out for its ``lax.scan``; the port loops over them.  This
slice runs attention (``attn``, ``attn_local``) with the dense MLP or the
mixture of experts (``moe``) on f32 or bf16 weights in f32 or bf16 compute
(the registered configs' default: bf16 activations, each routed matmul
summed in f32 and rounded once); what it does not run raises
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.common.util import Device, resolve_device
from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.core import router
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

# the mixer kind of each attention layer spec
_ATTN_KIND = {"attn": "causal", "attn_local": "local"}
FFN_PORTED = ("mlp", "moe")


def check_supported(cfg: ArchConfig) -> None:
    """Refuse what this slice of the port does not run."""
    for layer in cfg.all_layers():
        if layer.mixer not in _ATTN_KIND:
            raise NotImplementedError(
                f"{cfg.name}: mixer {layer.mixer!r} is not ported (cross and shared "
                "attention, mamba2, mLSTM and sLSTM come with a later slice)")
        if layer.ffn not in FFN_PORTED:
            raise NotImplementedError(f"{cfg.name}: ffn {layer.ffn!r} is not ported "
                                      "(shared MLPs come with a later slice)")
    if cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend!r} frontend is not ported")
    for field in ("compute_dtype", "param_dtype"):
        if getattr(cfg, field) not in ("float32", "bfloat16"):
            raise NotImplementedError(f"{cfg.name}: {field} {getattr(cfg, field)!r} is not "
                                      "ported (float32 and bfloat16 are)")
    if cfg.attn_logit_softcap != 0:
        raise NotImplementedError(f"{cfg.name}: attn_logit_softcap is not ported")


# ---------------------------------------------------------------- specs, caches


def layer_specs(cfg: ArchConfig, spec: LayerSpec, *, d_ff_override: Optional[int] = None
                ) -> dict:
    """An attention layer with its MLP (``d_ff_override`` wide) or its MoE."""
    ffn = moe_specs(cfg) if spec.ffn == "moe" else mlp_specs(cfg, d_ff_override)
    return {"mixer": attn_specs(cfg), "ffn": ffn}


def model_specs(cfg: ArchConfig) -> dict:
    check_supported(cfg)
    dt = cfg.param_dtype
    d, v = cfg.d_model, cfg.padded_vocab
    specs: dict = {"embed": ParamSpec((v, d), ("vocab", "embed"), "small_normal", dtype=dt)}
    for i, s in enumerate(cfg.head_pattern):
        specs[f"pre{i}"] = layer_specs(cfg, s, d_ff_override=cfg.first_dense_ff or None)
    superblock = {f"l{i}": layer_specs(cfg, s) for i, s in enumerate(cfg.block_pattern)}
    specs["blocks"] = pspec.stack_specs(superblock, cfg.num_superblocks)
    for i, s in enumerate(cfg.tail_pattern):
        specs[f"tail{i}"] = layer_specs(cfg, s)
    specs["final_norm"] = ParamSpec((d,), ("embed",), "zeros", dtype=dt)
    specs["lm_head"] = ParamSpec((d, v), ("embed", "vocab"), "small_normal", dtype=dt)
    return specs


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, *, device: Device = None) -> dict:
    """Empty caches: ``blocks`` holds one :class:`AttnCache` per superblock
    layer with every leaf stacked over the superblocks (batch on axis 1), the
    head and tail layers one each (batch on axis 0), ``lengths`` (B,) int32."""
    check_supported(cfg)
    dev = resolve_device(device)

    def layer_cache(s: LayerSpec) -> AttnCache:
        return init_attn_cache(cfg, batch, cache_len, kind=_ATTN_KIND[s.mixer], device=dev)

    cache: dict = {
        "blocks": {f"l{i}": AttnCache(*(torch.stack([leaf] * cfg.num_superblocks)
                                        for leaf in layer_cache(s)))
                   for i, s in enumerate(cfg.block_pattern)},
        "lengths": torch.zeros(batch, dtype=torch.int32, device=dev),
    }
    for i, s in enumerate(cfg.head_pattern):
        cache[f"pre{i}"] = layer_cache(s)
    for i, s in enumerate(cfg.tail_pattern):
        cache[f"tail{i}"] = layer_cache(s)
    return cache


# ---------------------------------------------------------------- layers


def _apply_layer(lp: dict, h: torch.Tensor, cfg: ArchConfig, spec: LayerSpec, *, mode: str,
                 cache: Optional[AttnCache] = None, lengths: Optional[torch.Tensor] = None):
    """Returns (h, cache, aux): the attention mixer, then the MLP or the MoE
    (aux its load-balance loss; 0.0 for the MLP, a float: no kernel)."""
    kind = _ATTN_KIND[spec.mixer]
    if kind == "causal" and not cfg.causal:
        kind = "full"
    h, cache = attn_apply(lp["mixer"], h, cfg, kind=kind, cache=cache, lengths=lengths,
                          mode=mode)
    if spec.ffn == "moe":
        h, aux = moe_apply(lp["ffn"], h, cfg)
        return h, cache, aux
    return mlp_apply(lp["ffn"], h, cfg), cache, 0.0


def _index(tree: Any, i: int) -> Any:
    """Superblock ``i`` of a stacked tree (views: writes reach the stack)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, AttnCache):
        return AttnCache(*(leaf[i] for leaf in tree))
    return tree[i]


def _layers(params: dict, cfg: ArchConfig, h: torch.Tensor, *, mode: str,
            cache: Optional[dict] = None) -> tuple[torch.Tensor, Any]:
    """Every layer in order: head, the superblocks (a loop in place of the
    reference's scan), tail.  Caches are written in place.  Returns (h, the
    summed aux loss: an f32 tensor, or 0.0 without MoE layers), summed in
    the reference's order: head layers, each superblock's sum, tail layers."""
    lengths = cache["lengths"] if cache is not None else None

    def run(h, lp, spec, caches, key):
        c = caches[key] if caches is not None else None
        h, _, aux = _apply_layer(lp[key], h, cfg, spec, mode=mode, cache=c, lengths=lengths)
        return h, aux

    aux_total = 0.0
    for i, spec in enumerate(cfg.head_pattern):
        h, aux = run(h, params, spec, cache, f"pre{i}")
        aux_total = aux_total + aux
    for sb in range(cfg.num_superblocks):
        sbc = _index(cache["blocks"], sb) if cache is not None else None
        sb_aux = 0.0
        for i, spec in enumerate(cfg.block_pattern):
            h, aux = run(h, _index(params["blocks"], sb), spec, sbc, f"l{i}")
            sb_aux = sb_aux + aux
        aux_total = aux_total + sb_aux
    for i, spec in enumerate(cfg.tail_pattern):
        h, aux = run(h, params, spec, cache, f"tail{i}")
        aux_total = aux_total + aux
    return h, aux_total


# ---------------------------------------------------------------- forward passes


def _embed_input(params: dict, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """The embedding rows in the compute dtype.  The reference scales them by
    a numpy f32 scalar, which JAX types strongly: a bf16 row times it is
    f32, so under ``embed_scale`` (gemma3) the stack runs in f32 after one
    bf16 rounding of the embedding, and the port does the same."""
    h = params["embed"][batch["tokens"].long()].to(getattr(torch, cfg.compute_dtype))
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


def forward(params: dict, cfg: ArchConfig, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (logits (B, S, V) f32, the MoE layers' summed aux loss, an f32
    scalar: 0 without MoE layers)."""
    check_supported(cfg)
    h, aux = _layers(params, cfg, _embed_input(params, cfg, batch), mode="train")
    return _logits(params, cfg, h), torch.as_tensor(aux, dtype=torch.float32, device=h.device)


def _forward_cached(params: dict, cfg: ArchConfig, batch: dict, cache: dict, mode: str):
    check_supported(cfg)
    h = _embed_input(params, cfg, batch)
    h, _ = _layers(params, cfg, h, mode=mode, cache=cache)  # the aux dropped, as the reference's
    new_cache = dict(cache, lengths=cache["lengths"] + h.shape[1])
    return _logits(params, cfg, h[:, -1:, :]), new_cache  # the last position's logits


def prefill(params: dict, cfg: ArchConfig, batch: dict, cache: dict):
    """Fill the cache from a prompt batch ``{"tokens": (B, P)}``; returns
    (last-position logits (B, 1, V), the cache).  The cache's tensors are
    written in place; ``lengths`` grows by P for every row."""
    return _forward_cached(params, cfg, batch, cache, "prefill")


def decode_step(params: dict, cfg: ArchConfig, batch: dict, cache: dict):
    """One decode step: ``batch["tokens"]`` is (B, 1)."""
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

    def forward(self, params: dict, batch: dict):
        return forward(params, self.cfg, batch)

    def prefill(self, params: dict, batch: dict, cache: dict):
        return prefill(params, self.cfg, batch, cache)

    def decode_step(self, params: dict, batch: dict, cache: dict):
        return decode_step(params, self.cfg, batch, cache)
