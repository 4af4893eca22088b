"""qwen3-4b [dense]: 36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936
— qk_norm, GQA (the reference's ``configs/qwen3_4b.py``).

f32 weights (4.41 B parameters with the untied head, 17.6 GB) under the
registered bf16 compute: the layers of qwen3-0.6b at another width."""
from repro_torch.configs.base import ArchConfig, LayerSpec, register


@register("qwen3-4b")
def make() -> ArchConfig:
    return ArchConfig(
        name="qwen3-4b",
        family="dense",
        d_model=2560,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=9728,
        vocab_size=151936,
        block_pattern=(LayerSpec("attn", "mlp"),),
        num_superblocks=36,
        use_qk_norm=True,
        rope_theta=1e6,
        param_dtype="float32",
    )
