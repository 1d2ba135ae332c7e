"""MoE router: top-k gating and the GShard auxiliary loss.

Mirrors ``repro.moe.gating.gate``: softmax or sigmoid scores, an optional
aux-free selection bias (selection only, never the combine weights),
renormalisation of the selected weights, routed scaling, the
force-balanced ``ideal`` router, realized counts and the GShard loss, with
free or rack-limited routing (DeepSeek-V3's node-limited routing,
DESIGN.md S14: each token's top-k restricted to its ``rack_limit``
best-scoring racks, which bounds the racks its payload must reach at the
source).  The router runs in fp32.

Free and rack-limited routing, with or without the selection bias, take the
scores, the top-k and the counts from ``gating_topk`` (the hand-written
fused kernel, in its rack mode where the limit binds, on a CUDA tensor; its
plain version on a CPU tensor, :func:`_rack_limited_top_k` for the rack
selection); the router
projection before it is a ``torch.matmul``, as the JAX package leaves it
outside Pallas too.  The ideal router keeps its plain code on every
device: no TPU kernel computes it, and no served model of the port uses
it.

Gradients reach ``x`` and the router through the scores and the combine
weights (``gating_topk``'s autograd Function); the selection bias gets none
(it is detached, as the reference's ``stop_gradient``).
:func:`update_router_bias` is the reference's aux-free bias update, with
its two-level per-rack variant for rack-limited routing, applied outside
the gradient.  :func:`rack_copy_volumes` is the gate's deduplicated
payload-copy count by fabric tier.

Ties.  ``lax.top_k`` puts the lower expert index first among equal scores;
``torch.topk`` promises no order, so the plain selection is a stable
descending sort of the scores (plus the bias), cut to the first k columns,
and the kernel's argmax rounds prefer the lower index.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.kernels.gating_topk.ops import (
    gating_topk,
    rack_limited_ids,
    scores_of,
)

__all__ = ["GatingConfig", "GateOut", "gate", "gshard_aux_loss",
           "update_router_bias", "rack_copy_volumes"]

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
    # Rack-limited routing: each token's top-k is restricted to its
    # rack_limit best-scoring racks of num_racks expert groups (rack g owns
    # the contiguous experts [g E / G, (g + 1) E / G), the planner's home
    # layout).  rack_limit 0 or num_racks 1 routes freely; rack_limit ==
    # num_racks is free routing, bit for bit.
    rack_limit: int = 0
    num_racks: int = 1
    # A rack's score: the sum of its rack_group_topk largest expert keys
    # (DeepSeek-V3 uses 2), clamped to the experts a rack.
    rack_group_topk: int = 2

    def __post_init__(self):
        if self.num_racks < 1:
            raise ValueError(f"num_racks={self.num_racks} must be >= 1")
        if not 0 <= self.rack_limit <= self.num_racks:
            raise ValueError(
                f"rack_limit={self.rack_limit} must be in "
                f"[0, num_racks={self.num_racks}]")
        if self.rack_limit > 0:
            if self.num_experts % self.num_racks != 0:
                raise ValueError(
                    f"num_experts={self.num_experts} must be a multiple of "
                    f"num_racks={self.num_racks} for rack-limited routing")
            epg = self.num_experts // self.num_racks
            if self.rack_limit * epg < self.top_k:
                raise ValueError(
                    f"rack_limit={self.rack_limit} racks expose only "
                    f"{self.rack_limit * epg} experts < top_k={self.top_k}")
        if self.rack_group_topk < 1:
            raise ValueError(
                f"rack_group_topk={self.rack_group_topk} must be >= 1")

    @property
    def rack_limited(self) -> bool:
        """True when the rack-group mask path is active (may be vacuous)."""
        return self.rack_limit > 0 and self.num_racks > 1

    @property
    def rack_binding(self) -> bool:
        """True when the constraint binds (rack_limit < num_racks)."""
        return self.rack_limited and self.rack_limit < self.num_racks


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


def _rack_limited_top_k(sel_scores: torch.Tensor,
                        cfg: GatingConfig) -> torch.Tensor:
    """Group-limited top-k (DeepSeek-V3 node-limited routing), the plain
    version of the gate kernel's rack mode (mirrors ``repro.moe.gating.
    _rack_limited_top_k``): each rack scored by the sum of its top
    ``rack_group_topk`` (biased) keys, the ``rack_limit`` best racks kept,
    every other rack's experts at -inf, then the ordinary top-k.  At
    ``rack_limit == num_racks`` the selection is the free top-k, bit for
    bit."""
    return rack_limited_ids(sel_scores, cfg.top_k, cfg.num_racks,
                            cfg.rack_limit, cfg.rack_group_topk)


def rack_copy_volumes(expert_ids: torch.Tensor, home: torch.Tensor, *,
                      num_ranks: int, rack_size: int,
                      src_rank: int) -> torch.Tensor:
    """(3,) deduplicated at-gate payload copies by fabric tier: [local,
    intra_rack, inter_rack] (mirrors ``repro.moe.gating.rack_copy_volumes``).

    A token's payload moves once per distinct destination rank inside its
    rack (local: its own rank) and once per distinct destination rack
    outside it (the aggregated hop 1 of the two-hop wire), against the home
    placement, before any reroute."""
    dev = expert_ids.device
    dst_rank = home.to(_I64)[expert_ids.to(_I64)]                   # (T, k)
    ranks = torch.arange(num_ranks, dtype=_I64, device=dev)
    sent = (dst_rank[:, :, None] == ranks).any(dim=1)               # (T, R)
    same_rank = ranks == src_rank
    same_rack = (ranks // rack_size) == (src_rank // rack_size)
    G = num_ranks // rack_size
    racks = torch.arange(G, dtype=_I64, device=dev)
    rack_sent = ((dst_rank // rack_size)[:, :, None] == racks).any(dim=1)
    return torch.stack([(sent & same_rank).sum(),
                        (sent & same_rack & ~same_rank).sum(),
                        (rack_sent & (racks != src_rank // rack_size)).sum()])


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
        racks = (dict(num_racks=cfg.num_racks, rack_limit=cfg.rack_limit,
                      group_topk=cfg.rack_group_topk)
                 if cfg.rack_limited else {})
        expert_ids, sel, counts, scores = gating_topk(
            logits, k, score_fn=cfg.score_fn, bias=sel_bias, want_scores=True,
            **racks)
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
                       speed: float, *, num_racks: int = 1) -> torch.Tensor:
    """Aux-free bias update: nudge under-loaded experts up, overloaded down
    (mirrors ``repro.moe.gating.update_router_bias``).  bias (..., E) fp32,
    counts (..., E) the realized per-expert load (one row per layer).

    ``num_racks > 1`` is the two-level variant for rack-limited routing: a
    half-gain term of each expert against its own rack's mean load (which
    reorders the restricted top-k) plus a full-gain term of the rack's mean
    against the global mean, the same for every expert of the rack (which
    steers the rack choice, whose group score sums biased keys).
    ``num_racks == 1`` is the global update, bit for bit."""
    load = counts.to(torch.float32)
    if num_racks > 1:
        E = load.shape[-1]
        if E % num_racks != 0:
            raise ValueError(f"num_experts={E} must be a multiple of "
                             f"num_racks={num_racks}")
        rack_mean = load.reshape(load.shape[:-1] + (num_racks, -1)).mean(
            dim=-1).repeat_interleave(E // num_racks, dim=-1)
        err = rack_mean - load
        steer = load.mean(dim=-1, keepdim=True) - rack_mean
        return bias + speed * (0.5 * torch.sign(err) + torch.sign(steer))
    return bias + speed * torch.sign(load.mean(dim=-1, keepdim=True) - load)
