"""Architecture configuration of the port's LM stack (the reference's
``configs/base.py``).

A model is embed -> head layers -> ``num_superblocks`` repeats of the
superblock ``block_pattern`` -> tail layers -> final norm -> logits head.
The reference scans over the superblocks; the port loops over them, and keeps
their parameters and caches stacked on a leading axis as the reference does.

The fields that chose an implementation in the reference (``use_pallas``,
``attn_impl``, ``inner_unroll``, ``attn_av_dtype``, ``scan_layers``) are
left out: the port has one implementation per device.  The distribution
fields (``fsdp``, ``shard_kv_seq_decode``, ``sequence_parallel``,
``moe_dp_attention``) are here, with the reference's defaults: the sharding
rules (:mod:`repro_torch.distributed.sharding`) and the activation
constraints read them.  ``remat`` is left out too:
the port's eager training loop keeps every activation, and at the full-width
batches it trains (qwen3-0.6b at 8 x 128 tokens) they fit the card.  The
frontend group is here (``is_encoder_only``, ``frontend``,
``num_image_tokens``; the frontends are the reference's stubs: precomputed
frame or patch embeddings come in), with ``supports_decode`` and
``shape_cells``, the cell names the reference assigns each arch.  The MoE sizes
and the combine type are here (the port serves the MoE layer), the
recurrent mixers' sizes (mamba2's state, heads, expansion and conv width,
the chunk of its and the mLSTM's scans, the mLSTM's up-projection), and
``optimizer`` (the port trains).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

from repro_torch.common.util import round_up

MIXER_KINDS = ("attn", "attn_local", "attn_cross", "attn_shared", "mamba2", "mlstm", "slstm", "none")
FFN_KINDS = ("mlp", "moe", "mlp_shared", "none")


@dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"
    ffn: str = "mlp"

    def __post_init__(self):
        if self.mixer not in MIXER_KINDS:
            raise ValueError(f"mixer must be one of {MIXER_KINDS}, got {self.mixer!r}")
        if self.ffn not in FFN_KINDS:
            raise ValueError(f"ffn must be one of {FFN_KINDS}, got {self.ffn!r}")


@dataclass(frozen=True)
class ArchConfig:
    # -- identity
    name: str = "unnamed"
    family: str = "dense"  # dense|moe|ssm|hybrid|vlm|audio
    # -- core dims
    d_model: int = 512
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 64
    d_ff: int = 2048
    vocab_size: int = 32000
    # -- depth as superblocks
    block_pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    num_superblocks: int = 4
    head_pattern: tuple[LayerSpec, ...] = ()  # layers before the superblocks
    tail_pattern: tuple[LayerSpec, ...] = ()  # layers after them
    # -- attention
    causal: bool = True
    mlp_gated: bool = True  # SwiGLU vs plain (gelu) MLP
    window_size: int = 0  # sliding window of attn_local
    use_qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_theta_local: float = 10_000.0  # theta of the local layers (gemma3)
    attn_logit_softcap: float = 0.0
    embed_scale: bool = False  # multiply embeddings by sqrt(d_model) (gemma)
    # -- MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    first_dense_ff: int = 0  # FFN width of the dense head layers (kimi-style); 0 = d_ff
    # -- SSM / recurrent
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256  # the chunk of the mamba2 and mLSTM scans
    ssm_conv_width: int = 4
    mlstm_proj_factor: int = 2
    # -- modality frontend (a stub, as the reference's: embeddings come in)
    is_encoder_only: bool = False
    frontend: str = "none"  # none|audio_frames|vision_patches
    num_image_tokens: int = 0
    # -- numerics
    matmul_accum_dtype: str = "float32"
    moe_combine_dtype: str = "float32"  # dtype of the expert outputs' gather and combine
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    optimizer: str = "adamw"  # adamw|adafactor|sgd
    vocab_round_to: int = 128
    # -- distribution (read by the sharding rules and the activation constraints)
    fsdp: bool = True  # shard the embed dim of every parameter over (pod, data)
    shard_kv_seq_decode: bool = False  # decode caches' sequence over the model axis
    sequence_parallel: bool = False  # the residual stream's sequence over the model axis
    moe_dp_attention: bool = False  # the Switch/GShard layout: batch over every axis, no TP
    # -- technique (Octopus)
    router_policy: str = "collaborative"  # collaborative|arype_only|vpe_only

    # -- derived
    @property
    def num_layers(self) -> int:
        return (len(self.block_pattern) * self.num_superblocks
                + len(self.head_pattern) + len(self.tail_pattern))

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab_size, self.vocab_round_to)

    @property
    def gqa_groups(self) -> int:
        if self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError(f"num_heads {self.num_heads} is not a multiple of "
                             f"num_kv_heads {self.num_kv_heads}")
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def mlstm_d_inner(self) -> int:
        return self.mlstm_proj_factor * self.d_model

    @property
    def supports_decode(self) -> bool:
        return not self.is_encoder_only

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the reference's long_500k cell: recurrent or hybrid,
        or mostly sliding-window, and not encoder-only."""
        kinds = [l.mixer for l in self.all_layers()]
        recurrent = sum(k in ("mamba2", "mlstm", "slstm") for k in kinds)
        local = sum(k == "attn_local" for k in kinds)
        return (recurrent + local) >= len(kinds) // 2 and not self.is_encoder_only

    def all_layers(self) -> tuple[LayerSpec, ...]:
        return (self.head_pattern + self.block_pattern * self.num_superblocks
                + self.tail_pattern)

    def shape_cells(self) -> list[str]:
        """Which of the reference's four assigned shape cells apply to this
        arch (their sizes live in the reference's ``configs/base.py:SHAPES``)."""
        cells = ["train_4k", "prefill_32k"]
        if self.supports_decode:
            cells.append("decode_32k")
            if self.sub_quadratic:
                cells.append("long_500k")
        return cells

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


_REGISTRY: dict[str, Callable[[], ArchConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ArchConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (registers the archs)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)


def reduced_config(cfg: ArchConfig) -> ArchConfig:
    """A tiny same-family config for CPU tests (the reference's rule)."""
    kw = dict(
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        num_superblocks=min(cfg.num_superblocks, 2),
        window_size=min(cfg.window_size, 16) if cfg.window_size else 0,
        num_image_tokens=16 if cfg.num_image_tokens else 0,
        param_dtype="float32",
        compute_dtype="float32",
        vocab_round_to=16,
        fsdp=False,
    )
    if cfg.num_experts:
        # a capacity factor high enough that the reduced configs drop no token
        kw.update(num_experts=4, experts_per_token=2, moe_d_ff=32,
                  num_shared_experts=min(cfg.num_shared_experts, 1),
                  first_dense_ff=64 if cfg.first_dense_ff else 0,
                  capacity_factor=8.0)
    if cfg.ssm_state:  # the mLSTM's chunk stays: only an SSM config has a state
        kw.update(ssm_state=8, ssm_head_dim=16, ssm_chunk=8)
    return cfg.replace(**kw)
