"""starcoder2-15b [dense]: 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152 — GQA, RoPE, a plain gelu MLP, bf16 weights (the reference's
``configs/starcoder2_15b.py``).

At 15.96 B parameters in bf16 it holds 31.9 GB, which fits one 80 GB card: the
port serves it at full width and depth, every matmul on the engines' bf16 x
bf16 arm.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register


@register("starcoder2-15b")
def make() -> ArchConfig:
    return ArchConfig(
        name="starcoder2-15b",
        family="dense",
        d_model=6144,
        num_heads=48,
        num_kv_heads=4,
        head_dim=128,
        d_ff=24576,
        vocab_size=49152,
        block_pattern=(LayerSpec("attn", "mlp"),),
        num_superblocks=40,
        mlp_gated=False,  # starcoder2 uses a plain gelu MLP (keeps ~15B params)
        rope_theta=1e5,
        param_dtype="bfloat16",
        optimizer="adamw",
    )
