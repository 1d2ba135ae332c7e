"""Optimizers (mirrors ``repro.optim``): AdamW, the cosine schedule,
global-norm clipping."""

from repro_torch.optim.optimizer import (  # noqa: F401
    AdamWState,
    Optimizer,
    adamw,
    apply_updates,
    clip_by_global_norm,
    cosine_schedule,
)
