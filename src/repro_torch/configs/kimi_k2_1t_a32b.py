"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) expert d_ff=2048
vocab=163840, MoE 384 experts top-8 + 1 shared expert, the first layer dense
(the reference's ``configs/kimi_k2_1t_a32b.py``).

At 1.04 T parameters in bf16 (2.1 TB) it does not fit one card.  It is
registered for its reduced form, which runs the shared expert and the dense
first layer.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register


@register("kimi-k2-1t-a32b")
def make() -> ArchConfig:
    return ArchConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        d_model=7168,
        num_heads=64,
        num_kv_heads=8,
        head_dim=112,
        d_ff=2048,  # per-expert width
        vocab_size=163840,
        head_pattern=(LayerSpec("attn", "mlp"),),  # layer 0 dense
        block_pattern=(LayerSpec("attn", "moe"),),
        num_superblocks=60,
        num_experts=384,
        experts_per_token=8,
        moe_d_ff=2048,
        num_shared_experts=1,
        first_dense_ff=16384,
        rope_theta=5e4,
        param_dtype="bfloat16",
        optimizer="adafactor",
        compute_dtype="bfloat16",
    )
