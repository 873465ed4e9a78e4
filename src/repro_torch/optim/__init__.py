"""Optimizers and learning-rate schedules (the port of ``repro.optim``)."""
from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adamw, apply_updates, clip_by_global_norm, global_norm, sgd,
)
from repro_torch.optim.schedules import (  # noqa: F401
    constant, linear_warmup_cosine, linear_warmup_linear_decay,
)
