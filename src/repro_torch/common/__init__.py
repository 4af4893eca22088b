from repro_torch.common.util import (
    ACTIVATIONS,
    apply_activation,
    ceil_div,
    resolve_device,
    round_up,
    segment_ranks,
)
