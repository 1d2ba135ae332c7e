"""MoE router: top-k gating and the GShard auxiliary loss.

Mirrors ``repro.moe.gating.gate`` on free routing: softmax or sigmoid
scores, an optional aux-free selection bias (selection only, never the
combine weights), renormalisation of the selected weights, routed scaling,
the force-balanced ``ideal`` router, realized counts and the GShard loss.
Rack-limited routing is not ported yet.  The router runs in fp32.

Free routing, with or without the selection bias, takes the scores, the
top-k and the counts from ``gating_topk`` (the hand-written fused kernel
on a CUDA tensor, its plain version on a CPU tensor); the router
projection before it is a ``torch.matmul``, as the JAX package leaves it
outside Pallas too.  The ideal router keeps its plain code on every
device: no TPU kernel computes it, and no served model of the port uses
it.

Gradients reach ``x`` and the router through the scores and the combine
weights (``gating_topk``'s autograd Function); the selection bias gets none
(it is detached, as the reference's ``stop_gradient``).
:func:`update_router_bias` is the reference's aux-free bias update on free
routing (its ``num_racks == 1`` branch), applied outside the gradient.

Ties.  ``lax.top_k`` puts the lower expert index first among equal scores;
``torch.topk`` promises no order, so the plain selection is a stable
descending sort of the scores (plus the bias), cut to the first k columns,
and the kernel's argmax rounds prefer the lower index.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.kernels.gating_topk.ops import gating_topk, scores_of

__all__ = ["GatingConfig", "GateOut", "gate", "gshard_aux_loss",
           "update_router_bias"]

_I64 = torch.int64


@dataclasses.dataclass(frozen=True)
class GatingConfig:
    num_experts: int
    top_k: int
    score_fn: str = "softmax"          # "softmax" | "sigmoid"
    norm_topk_prob: bool = True        # renormalise selected weights to sum 1
    aux_loss_weight: float = 0.0       # GShard loss coefficient
    routed_scaling: float = 1.0
    use_bias: bool = False             # aux-free routing bias (DeepSeek)
    ideal: bool = False                # force-balanced round-robin router


class GateOut(NamedTuple):
    expert_ids: torch.Tensor   # (T, k) selected logical experts
    weights: torch.Tensor      # (T, k) combine weights (activation dtype)
    counts: torch.Tensor       # (E,) realized per-expert token load
    aux_loss: torch.Tensor     # () scalar (0 when disabled)
    scores: torch.Tensor       # (T, E) router probabilities (fp32)


def _histogram(ids: torch.Tensor, num_experts: int) -> torch.Tensor:
    """(E,) int64 count of each expert id: ``torch.bincount`` without its
    read of ``ids.max()`` (a host sync on a CUDA tensor)."""
    flat = ids.reshape(-1).to(_I64)
    return torch.zeros(num_experts, dtype=_I64, device=ids.device
                       ).scatter_add_(0, flat, torch.ones_like(flat))


def gshard_aux_loss(scores: torch.Tensor, expert_ids: torch.Tensor,
                    num_experts: int) -> torch.Tensor:
    """GShard load-balancing loss: E * sum_e f_e * P_e."""
    T, k = expert_ids.shape
    f = _histogram(expert_ids, num_experts).to(torch.float32) / (T * k)
    p = scores.mean(dim=0)
    return num_experts * torch.sum(f * p)


def gate(x: torch.Tensor, w_router: torch.Tensor, cfg: GatingConfig, *,
         bias: torch.Tensor | None = None) -> GateOut:
    """Route tokens.  x: (T, D); w_router: (D, E); bias: (E,) or None."""
    T = x.shape[0]
    E, k = cfg.num_experts, cfg.top_k
    logits = x.to(torch.float32) @ w_router.to(torch.float32)
    if not cfg.ideal:
        # The bias steers selection only; the weights are the unbiased
        # scores.
        sel_bias = bias.detach() if cfg.use_bias and bias is not None else None
        expert_ids, sel, counts, scores = gating_topk(
            logits, k, score_fn=cfg.score_fn, bias=sel_bias, want_scores=True)
    else:
        scores = scores_of(logits, cfg.score_fn)
        base = (torch.arange(T, dtype=_I64, device=x.device) * k) % E
        expert_ids = (base[:, None]
                      + torch.arange(k, dtype=_I64, device=x.device)) % E
        sel = torch.gather(scores, 1, expert_ids)
        counts = _histogram(expert_ids, E)
    if cfg.norm_topk_prob:
        sel = sel / sel.sum(dim=-1, keepdim=True).clamp(min=1e-20)
    sel = sel * cfg.routed_scaling

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.aux_loss_weight > 0.0:
        aux = cfg.aux_loss_weight * gshard_aux_loss(scores, expert_ids, E)
    return GateOut(expert_ids, sel.to(x.dtype), counts, aux, scores)


def update_router_bias(bias: torch.Tensor, counts: torch.Tensor,
                       speed: float) -> torch.Tensor:
    """Aux-free bias update: nudge under-loaded experts up, overloaded down
    (mirrors ``repro.moe.gating.update_router_bias`` with ``num_racks ==
    1``; rack-limited routing is not ported).  bias (..., E) fp32, counts
    (..., E) the realized per-expert load (one row per layer)."""
    load = counts.to(torch.float32)
    return bias + speed * torch.sign(load.mean(dim=-1, keepdim=True) - load)
