"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) expert d_ff=512
vocab=49155, MoE 32 experts top-8 (the reference's
``configs/granite_moe_1b_a400m.py``; hf:ibm-granite/granite-3.0-1b-a400m-base).

The 512-wide experts are the Octopus under-utilization regime at LM scale.
vocab 49155 is padded to a multiple of 128 (49280; the padded logits are
masked).  About 1.4 B parameters, 5.5 GB in f32: one card holds it whole.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register


@register("granite-moe-1b-a400m")
def make() -> ArchConfig:
    return ArchConfig(
        name="granite-moe-1b-a400m",
        family="moe",
        d_model=1024,
        num_heads=16,
        num_kv_heads=8,
        head_dim=64,
        d_ff=512,
        vocab_size=49155,
        block_pattern=(LayerSpec("attn", "moe"),),
        num_superblocks=24,
        num_experts=32,
        experts_per_token=8,
        moe_d_ff=512,
        rope_theta=1e4,
        param_dtype="float32",
    )
