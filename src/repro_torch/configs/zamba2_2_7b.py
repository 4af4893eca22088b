"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000,
ssm_state=64: Mamba-2 blocks and a shared (tied-weight) attention + MLP
block (the reference's ``configs/zamba2_2_7b.py``; arXiv:2411.15242).

A superblock is 5 mamba2 + 1 shared attention block, x9 = 54 layers.  The
shared block's weights live once in ``params["shared"]`` and every
superblock reuses them; its KV cache is per occurrence.  head_dim 80 is the
first attention width that is not a power of two (the bf16 flash tile pads
it to 128).  About 2.06 B parameters, 8.3 GB in f32: one card holds it
whole.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register

_M = LayerSpec("mamba2", "none")
_A = LayerSpec("attn_shared", "mlp_shared")


@register("zamba2-2.7b")
def make() -> ArchConfig:
    return ArchConfig(
        name="zamba2-2.7b",
        family="hybrid",
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        head_dim=80,
        d_ff=10240,
        vocab_size=32000,
        block_pattern=(_M, _M, _M, _M, _M, _A),
        num_superblocks=9,
        ssm_state=64,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_chunk=256,
        rope_theta=1e4,
        param_dtype="float32",
        optimizer="adamw",
    )
