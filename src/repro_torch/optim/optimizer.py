"""AdamW, Adafactor, the cosine schedule, global-norm clipping and update
application.

Mirrors ``repro.optim.optimizer`` (``adamw``, ``adafactor``,
``cosine_schedule``, ``clip_by_global_norm``, ``apply_updates``).
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

On a mesh each parameter is this rank's shard of it
(``repro_torch.parallel.sharding``), and the optimizers take each
parameter's :class:`~repro_torch.parallel.sharding.Placement`
(``update(..., placements=)``, ``clip_by_global_norm(..., spans=)``): the
group each dimension is split over, and ``span``, the group whose ranks
hold its distinct shards.  AdamW is elementwise, so it updates a shard as
it is, and its moments take the shard's shape (the reference's
``opt_state_specs``: ZeRO falls out of FSDP).  Adafactor's state is small (factored second moments, no first moment)
and mirrors its parameter's placement (the reference's
``opt_state_specs``: v_row drops the last dimension's entry, v_col the
second last): where a statistic spans a split dimension it is summed over
that dimension's group, so every shard sees the unsharded values, as
GSPMD gives them to the reference: v_row's mean over a split last
dimension, v_col's and v_row's means over a split second last, and the
update's RMS over every split (``span``).  :func:`reduce_grads`, the
gradients' sums over their groups, runs in pieces of at most
``BUCKET_BYTES`` (gloo stages CUDA tensors through the host).
:func:`clip_by_global_norm` counts each element once: the squares of a
split parameter are summed over its ``span``, and a replicated one counts
once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.parallel import collectives

__all__ = ["Optimizer", "AdamWState", "adamw", "AdafactorState",
           "adafactor", "cosine_schedule", "clip_by_global_norm",
           "apply_updates", "reduce_grads", "CHUNK", "BUCKET_BYTES"]

CHUNK = 1 << 26            # elements per fp32 slice of an update
BUCKET_BYTES = 256 << 20   # most bytes a gradient sum moves at a time


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


def _pieces(flat: torch.Tensor):
    """``flat`` in slices of at most BUCKET_BYTES."""
    step = max(1, BUCKET_BYTES // flat.element_size())
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


def clip_by_global_norm(grads: list, max_norm: float, *, spans=None):
    """Scale ``grads`` in place so their global L2 norm (fp32) is at most
    ``max_norm``; returns the norm before clipping, a device scalar.

    On a mesh ``spans[i]`` is the group whose ranks hold gradient i's
    distinct shards (None: whole on every rank): each group's squares are
    summed over it, in the order the groups first appear (the same on
    every rank), and a whole gradient counts once."""
    if spans is None:
        total = _sq_sum(grads)
    else:
        order, parts = [], {}
        for g, sp in zip(grads, spans):
            if id(sp) not in parts:
                order.append(sp)
                parts[id(sp)] = []
            parts[id(sp)].append(g)
        total = None
        for sp in order:
            t = _sq_sum(parts[id(sp)])
            if sp is not None and sp.size > 1:
                t = collectives.all_reduce(sp, t)
            total = t if total is None else total + t
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


def adamw(lr: float | Callable, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: float(lr))

    def init(params: list) -> AdamWState:
        """Zero moments, each the shape of its parameter (its shard)."""
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return AdamWState(mu=[zeros(p) for p in params],
                          nu=[zeros(p) for p in params])

    def _apply(gs, ms, ns, ps, c1, c2, lr_t):
        gf = gs.to(torch.float32)
        ms.mul_(b1).add_(gf, alpha=1 - b1)
        ns.mul_(b2).add_(gf * gf, alpha=1 - b2)
        u = (ms / c1) / (torch.sqrt(ns / c2) + eps)
        u.add_(ps.to(torch.float32), alpha=weight_decay).mul_(-lr_t)
        ps.add_(u.to(ps.dtype))

    @torch.no_grad()
    def update(grads: list, state: AdamWState, params: list, step: int,
               *, placements=None) -> AdamWState:
        """``placements`` is ignored: the update is elementwise."""
        del placements
        stepf = step + 1.0
        lr_t = lr_fn(step)
        c1, c2 = 1 - b1 ** stepf, 1 - b2 ** stepf
        for g, m, n, p in zip(grads, state.mu, state.nu, params):
            if not p.is_contiguous():
                raise ValueError("adamw updates contiguous parameters in place")
            for a in zip(_slices(g.contiguous()), _slices(m), _slices(n),
                         _slices(p)):
                _apply(*a, c1, c2, lr_t)
        return state

    return Optimizer(init=init, update=update)


class AdafactorState(NamedTuple):
    v_row: list   # fp32: shape[:-1] if factored, else the full v
    v_col: list   # fp32: shape[:-2] + shape[-1:] if factored, else ()


def _factored(p: torch.Tensor) -> bool:
    return p.dim() >= 2


def _row_blocks(p: torch.Tensor):
    """(lead index, first row, last row) of a factored (*lead, R, C)
    tensor in blocks of at most CHUNK elements."""
    R, C = p.shape[-2], p.shape[-1]
    step = max(1, CHUNK // max(C, 1))
    for lead in range(p.numel() // max(R * C, 1)):
        for lo in range(0, R, step):
            yield lead, lo, min(R, lo + step)


def _mean_over(sq: torch.Tensor, p: torch.Tensor, grp) -> torch.Tensor:
    """``sq`` (a sum over ``p``) over the elements of the whole tensor:
    ``p``'s alone, or summed over its shards on every rank of ``grp``."""
    if grp is None or grp.size == 1:
        return sq / p.numel()
    return collectives.all_reduce(grp, sq) / (p.numel() * grp.size)


def adafactor(lr: float | Callable, decay: float = 0.99, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern), no first moment.

    The reference's arithmetic, in fp32: g2 = g^2 + eps; a tensor of two
    or more dims keeps v_row (the mean of g2 over its last axis) and v_col
    (over its second last), ``decay`` averages of them, and
    u = g / sqrt(max(v_row / max(mean(v_row), eps) v_col, eps)); a vector
    or scalar keeps the whole v.  The update's RMS is clipped to
    ``clip_threshold`` and p += -lr u, rounded to p's dtype, in place.

    A factored tensor is walked in blocks of at most ``CHUNK`` elements
    (rows of its last two axes) three times, so no fp32 temporary of its
    size is made (an expert weight's u would be 15 GB at DeepSeek-V3's
    width): first the statistics (v_row, and v_col as a sum over the
    blocks), then the RMS of u, then the update, with u recomputed each
    time.  On a mesh the state takes the parameter's shard and each
    replica computes the same update from
    the same summed gradient; ``update(..., placements=)`` sums the
    statistics that span a split dimension over its group (the module's
    notes)."""
    lr_fn = lr if callable(lr) else (lambda _: float(lr))

    def init(params: list) -> AdafactorState:
        f32 = dict(dtype=torch.float32)

        def vr(p):
            shape = p.shape[:-1] if _factored(p) else p.shape
            return torch.zeros(shape, device=p.device, **f32)

        def vc(p):
            shape = p.shape[:-2] + p.shape[-1:] if _factored(p) else ()
            return torch.zeros(shape, device=p.device, **f32)

        return AdafactorState(v_row=[vr(p) for p in params],
                              v_col=[vc(p) for p in params])

    def _u_factored(g3, vr2, vc2, rmean, lead, lo, hi):
        gf = g3[lead, lo:hi].to(torch.float32)
        denom = (vr2[lead, lo:hi, None] / rmean[lead]) * vc2[lead, None, :]
        return gf * torch.rsqrt(torch.clamp(denom, min=eps))

    def _update_factored(g, vr, vc, p, lr_t, grp, gr, gc):
        R, C = p.shape[-2], p.shape[-1]
        g3 = g.reshape(-1, R, C)
        p3 = p.view(-1, R, C)
        vr2, vc2 = vr.view(-1, R), vc.view(-1, C)
        col = torch.zeros_like(vc2)
        for lead, lo, hi in _row_blocks(p):
            gf = g3[lead, lo:hi].to(torch.float32)
            g2 = gf * gf + eps
            if gc is None:
                mean = g2.mean(dim=-1)
            else:
                mean = collectives.all_reduce(gc, g2.sum(dim=-1)) / (
                    C * gc.size)
            vr2[lead, lo:hi].mul_(decay).add_((1 - decay) * mean)
            col[lead].add_(g2.sum(dim=0))
        if gr is not None:
            Rg = R * gr.size
            col = collectives.all_reduce(gr, col)
            rsum = collectives.all_reduce(gr, vr2.sum(dim=-1, keepdim=True))
            vc2.mul_(decay).add_((1 - decay) * (col / Rg))
            rmean = torch.clamp(rsum / Rg, min=eps)
        else:
            vc2.mul_(decay).add_((1 - decay) * (col / R))
            rmean = torch.clamp(vr2.mean(dim=-1, keepdim=True), min=eps)
        sq = torch.zeros((), dtype=torch.float32, device=p.device)
        for blk in _row_blocks(p):
            u = _u_factored(g3, vr2, vc2, rmean, *blk)
            sq = sq + torch.sum(u * u)
        rms = torch.sqrt(_mean_over(sq, p, grp) + 1e-12)
        div = torch.clamp(rms / clip_threshold, min=1.0)
        for blk in _row_blocks(p):
            u = _u_factored(g3, vr2, vc2, rmean, *blk) / div
            lead, lo, hi = blk
            p3[lead, lo:hi].add_((-lr_t * u).to(p.dtype))

    def _update_whole(g, vr, p, lr_t, grp):
        gf = g.to(torch.float32)
        vr.mul_(decay).add_((1 - decay) * (gf * gf + eps))
        u = gf * torch.rsqrt(torch.clamp(vr, min=eps))
        if grp is None:
            rms = torch.sqrt(torch.mean(u * u) + 1e-12)
        else:
            rms = torch.sqrt(_mean_over(torch.sum(u * u), p, grp) + 1e-12)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        p.add_((-lr_t * u).to(p.dtype))

    @torch.no_grad()
    def update(grads: list, state: AdafactorState, params: list, step: int,
               *, placements=None) -> AdafactorState:
        lr_t = lr_fn(step)
        pls = placements or [None] * len(params)
        for g, vr, vc, p, pl in zip(grads, state.v_row, state.v_col, params,
                                    pls):
            if not p.is_contiguous():
                raise ValueError("adafactor updates contiguous parameters "
                                 "in place")
            grp = None if pl is None else pl.span
            if grp is not None and grp.size == 1:
                grp = None
            if p.numel() == 0 and grp is None:
                continue
            if _factored(p):
                dims = (None, None) if pl is None else pl.dims[-2:]
                gr, gc = (None if d is None or d.size == 1 else d
                          for d in dims)
                _update_factored(g, vr, vc, p, lr_t, grp, gr, gc)
            else:
                _update_whole(g, vr, p, lr_t, grp)
        return state

    return Optimizer(init=init, update=update)
