"""llama-3.2-vision-90b [vlm]: 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — a cross-attention image layer every 5th layer (the
reference's ``configs/llama_3_2_vision_90b.py``).

The vision frontend is a stub, as in the reference: a batch brings
precomputed patch embeddings ``vision`` (B, num_image_tokens, d_model), and
the cross-attention layers attend to them (no rope on the cross keys).
Superblock = 4 self + 1 cross, x20.  87.7 B parameters, 175 GB of bf16: one
80 GB card holds 2 superblocks at full width (10.66 B, 21.3 GB).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register

_S = LayerSpec("attn", "mlp")
_X = LayerSpec("attn_cross", "mlp")


@register("llama-3.2-vision-90b")
def make() -> ArchConfig:
    return ArchConfig(
        name="llama-3.2-vision-90b",
        family="vlm",
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab_size=128256,
        block_pattern=(_S, _S, _S, _S, _X),
        num_superblocks=20,
        rope_theta=5e5,
        frontend="vision_patches",
        num_image_tokens=1600,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        optimizer="adamw",
    )
