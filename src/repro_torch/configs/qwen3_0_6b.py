"""qwen3-0.6b [dense]: 28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936
— qk_norm, GQA (the reference's ``configs/qwen3_0_6b.py``)."""
from repro_torch.configs.base import ArchConfig, LayerSpec, register


@register("qwen3-0.6b")
def make() -> ArchConfig:
    return ArchConfig(
        name="qwen3-0.6b",
        family="dense",
        d_model=1024,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,  # explicit head_dim=128 (q_dim 2048 != d_model)
        d_ff=3072,
        vocab_size=151936,
        block_pattern=(LayerSpec("attn", "mlp"),),
        num_superblocks=28,
        use_qk_norm=True,
        rope_theta=1e6,
        param_dtype="float32",
        optimizer="adamw",
    )
