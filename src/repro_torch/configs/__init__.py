"""Arch registry of the port: importing this package registers every
architecture the reference registers (qwen3-0.6b, qwen3-4b, gemma3-1b,
granite-moe-1b-a400m, starcoder2-15b, xlstm-1.3b, zamba2-2.7b,
hubert-xlarge, llama-3.2-vision-90b, kimi-k2-1t-a32b).  kimi-k2 in full and
llama-3.2-vision-90b at full depth are too large for one card: the port runs
kimi-k2 reduced and llama-vision at cut depth."""
from repro_torch.configs import (  # noqa: F401
    gemma3_1b,
    granite_moe_1b_a400m,
    hubert_xlarge,
    kimi_k2_1t_a32b,
    llama_3_2_vision_90b,
    qwen3_0_6b,
    qwen3_4b,
    starcoder2_15b,
    xlstm_1_3b,
    zamba2_2_7b,
)
from repro_torch.configs.base import (
    ArchConfig,
    LayerSpec,
    get_config,
    list_archs,
    reduced_config,
)
