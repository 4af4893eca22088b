"""Arch registry of the port: importing this package registers the
architectures whose models the port runs (qwen3-0.6b, qwen3-4b, gemma3-1b,
granite-moe-1b-a400m, starcoder2-15b; kimi-k2-1t-a32b, too large for one
card, in its reduced form only).  The reference's other architectures come
with later slices; ``get_config`` of one of them raises."""
from repro_torch.configs import (  # noqa: F401
    gemma3_1b,
    granite_moe_1b_a400m,
    kimi_k2_1t_a32b,
    qwen3_0_6b,
    qwen3_4b,
    starcoder2_15b,
)
from repro_torch.configs.base import (
    ArchConfig,
    LayerSpec,
    get_config,
    list_archs,
    reduced_config,
)
