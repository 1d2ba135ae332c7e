"""AdamW, the cosine schedule, global-norm clipping and update application.

Mirrors ``repro.optim.optimizer`` (``adamw``, ``cosine_schedule``,
``clip_by_global_norm``, ``apply_updates``; Adafactor is not ported yet).
The JAX optimizers are pure functions over pytrees; here the parameters are
a list of tensors updated in place, in each parameter's dtype, so that a
parameter that is a view (the MoE mains at the head of their slot buffers)
stays one.  The moments are fp32 and are updated in place too.  The
arithmetic is the reference's, element for element:

  m = b1 m + (1 - b1) g,  n = b2 n + (1 - b2) g^2,
  u = -lr_t (m / (1 - b1^t) / (sqrt(n / (1 - b2^t)) + eps) + wd p),
  p = p + u (rounded to p's dtype),

in fp32, one slice of at most ``CHUNK`` elements at a time, which bounds
the fp32 temporaries (a GLM-4.5-Air expert weight holds 738M elements).
The step count and the learning rate are host numbers: nothing here reads
the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

__all__ = ["Optimizer", "AdamWState", "adamw", "cosine_schedule",
           "clip_by_global_norm", "apply_updates", "CHUNK"]

CHUNK = 1 << 26            # elements per fp32 slice of an update


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[list], Any]
    # update(grads, state, params, step): applies the step's update to
    # params in place and returns the (in-place updated) state.
    update: Callable[[list, Any, list, int], Any]


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable[[int], float]:
    """Linear warmup to ``base_lr``, then a cosine to ``floor * base_lr``."""
    def lr(step) -> float:
        step = float(step)
        if step < warmup:
            return base_lr * min(step / max(warmup, 1), 1.0)
        t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return base_lr * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * t)))
    return lr


def _slices(t: torch.Tensor):
    flat = t.view(-1)
    for lo in range(0, flat.numel(), CHUNK):
        yield flat[lo:lo + CHUNK]


def clip_by_global_norm(grads: list, max_norm: float):
    """Scale ``grads`` in place so their global L2 norm (fp32) is at most
    ``max_norm``; returns the norm before clipping, a device scalar."""
    total = None
    for g in grads:
        for sl in _slices(g):
            s = torch.sum(torch.square(sl.to(torch.float32)))
            total = s if total is None else total + s
    gn = torch.sqrt(total)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return grads, gn


def apply_updates(params: list, updates: list) -> list:
    """p += u in each parameter's dtype, in place."""
    with torch.no_grad():
        for p, u in zip(params, updates):
            p.add_(u.to(p.dtype))
    return params


class AdamWState(NamedTuple):
    mu: list      # fp32, one per parameter
    nu: list


def adamw(lr: float | Callable, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: float(lr))

    def init(params: list) -> AdamWState:
        return AdamWState(
            mu=[torch.zeros_like(p, dtype=torch.float32) for p in params],
            nu=[torch.zeros_like(p, dtype=torch.float32) for p in params])

    @torch.no_grad()
    def update(grads: list, state: AdamWState, params: list,
               step: int) -> AdamWState:
        stepf = step + 1.0
        lr_t = lr_fn(step)
        c1, c2 = 1 - b1 ** stepf, 1 - b2 ** stepf
        for g, m, n, p in zip(grads, state.mu, state.nu, params):
            if not p.is_contiguous():
                raise ValueError("adamw updates contiguous parameters in place")
            for gs, ms, ns, ps in zip(_slices(g.contiguous()), _slices(m),
                                      _slices(n), _slices(p)):
                gf = gs.to(torch.float32)
                ms.mul_(b1).add_(gf, alpha=1 - b1)
                ns.mul_(b2).add_(gf * gf, alpha=1 - b2)
                u = (ms / c1) / (torch.sqrt(ns / c2) + eps)
                u.add_(ps.to(torch.float32), alpha=weight_decay).mul_(-lr_t)
                ps.add_(u.to(ps.dtype))
        return state

    return Optimizer(init=init, update=update)
