"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144
— 5:1 local:global sliding-window attention (the reference's
``configs/gemma3_1b.py``).

Superblock = 5 local + 1 global; 4 superblocks + 2 trailing local layers = 26.
Local layers use window 512 and rope theta 10k; globals theta 1M.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register

_L = LayerSpec("attn_local", "mlp")
_G = LayerSpec("attn", "mlp")


@register("gemma3-1b")
def make() -> ArchConfig:
    return ArchConfig(
        name="gemma3-1b",
        family="dense",
        d_model=1152,
        num_heads=4,
        num_kv_heads=1,
        head_dim=256,
        d_ff=6912,
        vocab_size=262144,
        block_pattern=(_L, _L, _L, _L, _L, _G),
        num_superblocks=4,
        tail_pattern=(_L, _L),
        window_size=512,
        use_qk_norm=True,
        rope_theta=1e6,
        rope_theta_local=1e4,
        embed_scale=True,
        param_dtype="float32",
        optimizer="adamw",
    )
