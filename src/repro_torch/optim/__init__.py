"""Optimizers (mirrors ``repro.optim``): AdamW, Adafactor, the cosine
schedule, global-norm clipping; ``grad_compress``, the int8 gradient
all-reduce with error feedback."""

from repro_torch.optim.optimizer import (  # noqa: F401
    AdafactorState,
    AdamWState,
    Optimizer,
    adafactor,
    adamw,
    apply_updates,
    clip_by_global_norm,
    cosine_schedule,
)
