"""hubert-xlarge [audio]: 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 —
an encoder-only transformer backbone (the reference's
``configs/hubert_xlarge.py``; arXiv:2106.07447).

The audio frontend (the conv feature encoder) is a stub, as in the
reference: a batch brings precomputed frame embeddings ``frames`` (B, S,
d_model), and the model has no embedding table.  Every layer attends
bidirectionally (``causal=False``: the full mask), head_dim 80 (the bf16
flash tile pads it to 128), a plain gelu MLP.  Training is masked-unit
prediction (per-frame cross entropy over the 504 cluster units).
Encoder-only: no decode path.  About 0.944 B parameters, 3.78 GB in f32: one
card holds it whole.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register


@register("hubert-xlarge")
def make() -> ArchConfig:
    return ArchConfig(
        name="hubert-xlarge",
        family="audio",
        d_model=1280,
        num_heads=16,
        num_kv_heads=16,
        head_dim=80,
        d_ff=5120,
        vocab_size=504,
        block_pattern=(LayerSpec("attn", "mlp"),),
        num_superblocks=48,
        mlp_gated=False,  # hubert uses a plain gelu MLP
        causal=False,
        is_encoder_only=True,
        frontend="audio_frames",
        rope_theta=1e4,
        vocab_round_to=8,
        param_dtype="float32",
        optimizer="adamw",
    )
