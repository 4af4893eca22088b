"""xlstm-1.3b [ssm]: 48 blocks d_model=2048 4H d_ff=0 vocab=50304, sLSTM and
mLSTM blocks at 7:1 (the reference's ``configs/xlstm_1_3b.py``;
arXiv:2405.04517).

d_ff=0: the blocks carry their own projections (the mLSTM up-projects 2x).
A superblock is 7 mLSTM + 1 sLSTM, x6 = 48 blocks.  The decode state does
not grow with the history.  About 1.77 B parameters, 7.1 GB in f32: one
card holds it whole.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register

_M = LayerSpec("mlstm", "none")
_S = LayerSpec("slstm", "none")


@register("xlstm-1.3b")
def make() -> ArchConfig:
    return ArchConfig(
        name="xlstm-1.3b",
        family="ssm",
        d_model=2048,
        num_heads=4,
        num_kv_heads=4,
        head_dim=512,
        d_ff=0,
        vocab_size=50304,
        block_pattern=(_M, _M, _M, _M, _M, _M, _M, _S),
        num_superblocks=6,
        mlstm_proj_factor=2,
        ssm_chunk=256,
        param_dtype="float32",
        optimizer="adamw",
    )
