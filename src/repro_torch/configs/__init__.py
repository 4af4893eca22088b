"""Arch registry of the port: importing this package registers the
architectures whose models the port runs (qwen3-0.6b, gemma3-1b).  The
reference's other architectures come with later slices; ``get_config`` of
one of them raises."""
from repro_torch.configs import gemma3_1b, qwen3_0_6b  # noqa: F401
from repro_torch.configs.base import (
    ArchConfig,
    LayerSpec,
    get_config,
    list_archs,
    reduced_config,
)
