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

On a mesh the moments may be sharded (``init(params, shards)``, the
:class:`repro_torch.parallel.sharding.MomentShard` of each parameter):
each rank then updates its moment shard and the matching slice of the
parameter, and an ``all_gather`` over the parameter's replica group puts
the parameter back together on every replica.  AdamW is elementwise, so
the sharded update is bitwise the unsharded one.  The gather runs in
pieces of at most ``BUCKET_BYTES`` (gloo stages CUDA tensors through the
host), as does :func:`reduce_grads`, the gradients' sums over their
groups.  :func:`clip_by_global_norm` takes the norm over the whole mesh
when given the EP group: expert shards' squares are summed over it, and
each replicated parameter counts once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.parallel import collectives

__all__ = ["Optimizer", "AdamWState", "adamw", "cosine_schedule",
           "clip_by_global_norm", "apply_updates", "reduce_grads", "CHUNK",
           "BUCKET_BYTES"]

CHUNK = 1 << 26            # elements per fp32 slice of an update
BUCKET_BYTES = 256 << 20   # most bytes a gradient sum or gather moves


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


def _pieces(flat: torch.Tensor, rows: int = 1):
    """``flat`` in slices of at most BUCKET_BYTES over ``rows`` ranks."""
    step = max(1, BUCKET_BYTES // (flat.element_size() * rows))
    for lo in range(0, flat.numel(), step):
        yield lo, flat[lo:lo + step]


def reduce_grads(grads: list, groups: list) -> list:
    """Each gradient summed in place over its group (None: left as it
    is), in pieces of at most BUCKET_BYTES.  Every rank of a group passes
    its gradients in the same order."""
    for g, grp in zip(grads, groups):
        if grp is None or grp.size == 1:
            continue
        if not g.is_contiguous():
            raise ValueError("reduce_grads sums contiguous gradients")
        for _, piece in _pieces(g.view(-1)):
            collectives.all_reduce_(grp, piece)
    return grads


def _sq_sum(grads):
    total = None
    for g in grads:
        for sl in _slices(g):
            s = torch.sum(torch.square(sl.to(torch.float32)))
            total = s if total is None else total + s
    return total


def clip_by_global_norm(grads: list, max_norm: float, *, sharded=None,
                        group=None):
    """Scale ``grads`` in place so their global L2 norm (fp32) is at most
    ``max_norm``; returns the norm before clipping, a device scalar.

    On a mesh ``sharded[i]`` marks the gradients of ``group``'s shards
    (the experts over the EP group): their squares are summed over the
    group, and every other gradient (replicated, whole on every rank)
    counts once."""
    if group is None or group.size == 1 or sharded is None:
        total = _sq_sum(grads)
    else:
        rep = _sq_sum([g for g, s in zip(grads, sharded) if not s])
        own = _sq_sum([g for g, s in zip(grads, sharded) if s])
        if own is None:
            own = torch.zeros((), dtype=torch.float32,
                              device=grads[0].device)
        own = collectives.all_reduce(group, own)
        total = own if rep is None else rep + own
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
    mu: list      # fp32, one per parameter (its shard on a mesh)
    nu: list
    shards: list | None = None   # MomentShard per parameter, or None


def _gather_into(p: torch.Tensor, ps: torch.Tensor, sh) -> None:
    """Every replica's updated slice ``ps`` put back into ``p``."""
    if all(s == 1 for s in p.shape[:sh.dim]):     # slices are row blocks
        p2 = p.view(sh.count, -1)
        for lo, piece in _pieces(ps.view(-1), sh.count):
            parts = collectives.all_gather(sh.group, piece)
            p2[:, lo:lo + piece.numel()].copy_(parts)
        return
    parts = collectives.all_gather(sh.group, ps)
    p.copy_(parts.movedim(0, sh.dim).flatten(sh.dim, sh.dim + 1))


def adamw(lr: float | Callable, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: float(lr))

    def init(params: list, shards: list | None = None) -> AdamWState:
        """Zero moments, each the shape of its parameter's moment shard
        (``shards``: one MomentShard per parameter, None: whole)."""
        def zeros(p, sh):
            shape = p.shape if sh is None else sh.shape(p.shape)
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        shs = shards or [None] * len(params)
        return AdamWState(mu=[zeros(p, sh) for p, sh in zip(params, shs)],
                          nu=[zeros(p, sh) for p, sh in zip(params, shs)],
                          shards=shards)

    def _apply(gs, ms, ns, ps, c1, c2, lr_t):
        gf = gs.to(torch.float32)
        ms.mul_(b1).add_(gf, alpha=1 - b1)
        ns.mul_(b2).add_(gf * gf, alpha=1 - b2)
        u = (ms / c1) / (torch.sqrt(ns / c2) + eps)
        u.add_(ps.to(torch.float32), alpha=weight_decay).mul_(-lr_t)
        ps.add_(u.to(ps.dtype))

    @torch.no_grad()
    def update(grads: list, state: AdamWState, params: list,
               step: int) -> AdamWState:
        stepf = step + 1.0
        lr_t = lr_fn(step)
        c1, c2 = 1 - b1 ** stepf, 1 - b2 ** stepf
        shards = state.shards or [None] * len(params)
        for g, m, n, p, sh in zip(grads, state.mu, state.nu, params, shards):
            if not p.is_contiguous():
                raise ValueError("adamw updates contiguous parameters in place")
            whole = sh is None or sh.whole
            ps = p if whole else sh.take(p).contiguous()
            gs = g if whole else sh.take(g)
            for a in zip(_slices(gs.contiguous()), _slices(m), _slices(n),
                         _slices(ps)):
                _apply(*a, c1, c2, lr_t)
            if not whole:
                _gather_into(p, ps, sh)
        return state

    return Optimizer(init=init, update=update)
