"""The port's optimizers (the reference's ``optim``)."""
from repro_torch.optim.optimizers import (
    AdamState,
    FactoredState,
    Optimizer,
    adafactor,
    adamw,
    clip_by_global_norm,
    cosine_schedule,
    make_optimizer,
    sgd,
)
