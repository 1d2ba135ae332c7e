"""UltraEP quota-driven replication planner, flat tier (paper Alg. 1).

Mirrors ``repro.core.planner`` at ``probe_parallelism=1`` with no rack tier
and no health weights: the same greedy feasibility oracle, threshold
bisection, locality-first NW-corner reroute and slot assignment, so the
plan tables are integer-identical to the JAX solve (and hence to the numpy
oracle ``repro.core.ref_planner``).

Control flow.  JAX runs both loops as ``lax.while_loop`` on the device.
Here they are one launch of a hand-written kernel on a CUDA tensor
(:mod:`repro_torch.kernels.plan_solve`, the paper's GPU-native solve,
S5.3) and, on a CPU tensor, its plain version: Python loops whose
conditions read scalars.  With one EP rank the interval is empty from the
start (``tau_lo = ceil(total / 1) = max(ell) = tau_hi``), so the solve
returns the home quota and ``tau = total`` with no launch and no read.
Everything around the loops (the expert order, the reroute, the slot map,
the cumsums) is tensor code, so a solve on the card reads nothing back.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.plan_solve.ops import plan_solve

__all__ = ["Plan", "solve_replication", "solve_reroute", "solve_plan",
           "slot_assignment", "token_targets", "occurrence_index",
           "cumulative_quota"]

_I64 = torch.int64


class Plan(NamedTuple):
    """Solved balancing plan for one (layer, microbatch) of one EP group."""

    u: torch.Tensor          # (E, R) quota table (post-reroute instance load)
    q: torch.Tensor          # (R, E, R) source -> instance reroute split
    x: torch.Tensor          # (R, N_slot) redundant slot map, -1 = empty
    tau: torch.Tensor        # () solved threshold
    hosted: torch.Tensor     # (R, E) bool physical-instance indicator
    pre_max: torch.Tensor    # () pre-balance max rank load
    post_max: torch.Tensor   # () post-balance max rank load
    cum_q: torch.Tensor      # (R, E, R) inclusive cumsum of q over dst rank
    cum_u: torch.Tensor      # (E, R) inclusive cumsum of u over instance rank


def _home_quota(lam_e: torch.Tensor, home: torch.Tensor, R: int) -> torch.Tensor:
    """(E, R) all load on the main instance: u[e, h(e)] = lam_e."""
    return torch.nn.functional.one_hot(home, R).to(_I64) * lam_e[:, None]


def _rank_load(lam_e: torch.Tensor, home: torch.Tensor, R: int) -> torch.Tensor:
    return torch.zeros(R, dtype=_I64, device=lam_e.device).index_add_(
        0, home, lam_e)


def _expert_order(lam_e: torch.Tensor, home: torch.Tensor, R: int) -> torch.Tensor:
    """(R, E/R) expert ids: per home rank, descending lam_e, stable by id.

    Mirrors ``repro.core.planner._expert_order`` (two stable sorts).
    """
    E = lam_e.shape[0]
    p1 = torch.sort(-lam_e, stable=True).indices
    p2 = torch.sort(home[p1], stable=True).indices
    return p1[p2].reshape(R, E // R)


def _flat_only(rack_size, health_weight, demand_tiebreak,
               probe_parallelism: int) -> None:
    if rack_size is not None:
        raise ValueError("rack_size: the rack-aware tier is not ported yet")
    if health_weight is not None:
        raise ValueError("health_weight: health-weighted solves are not "
                         "ported yet")
    if demand_tiebreak:
        raise ValueError("demand_tiebreak: rack co-design is not ported yet")
    if probe_parallelism != 1:
        raise ValueError("probe_parallelism > 1 is not ported yet")


def solve_replication(lam: torch.Tensor, home: torch.Tensor, *, n_slot: int,
                      u_min: int = 1,
                      max_replicas_per_expert: int | None = None,
                      probe_parallelism: int = 1, rack_size: int | None = None,
                      health_weight: torch.Tensor | None = None,
                      demand_tiebreak: bool = False,
                      load_bound: int | None = None):
    """Quota table U by threshold bisection (Alg. 1 lines 1-25).

    Mirrors ``repro.core.planner.solve_replication``.  Returns ``(u, tau)``:
    the (E, R) quota table and the solved threshold as a 0-d tensor.
    ``load_bound`` bounds ``lam.sum()`` from what the host knows (ranks x
    tokens per rank x top-k); a solve on the card at R > 1 needs it, since
    the kernel's int32 arithmetic takes totals below 2^31 only.
    """
    _flat_only(rack_size, health_weight, demand_tiebreak, probe_parallelism)
    lam = lam.to(_I64)
    home = home.to(_I64)
    R, E = lam.shape
    if E % R != 0:
        raise ValueError(f"E={E} must be a multiple of R={R}")
    max_rep = R if max_replicas_per_expert is None else max_replicas_per_expert

    lam_e = lam.sum(dim=0)
    if R == 1:
        # The interval is empty: the home quota, tau = total, no read.
        return _home_quota(lam_e, home, R), lam_e.sum()
    ell = _rank_load(lam_e, home, R)
    rank_experts = _expert_order(lam_e, home, R)
    return plan_solve(lam_e, ell, home, rank_experts, n_slot=n_slot,
                      u_min=u_min, max_replicas_per_expert=max_rep,
                      load_bound=load_bound)


def _nw_corner(demand: torch.Tensor, quota: torch.Tensor) -> torch.Tensor:
    """(..., N) marginals -> (..., N_src, N_dst) NW-corner transport plan."""
    a = torch.cumsum(demand, dim=-1)
    b = torch.cumsum(quota, dim=-1)
    a0 = a - demand
    b0 = b - quota
    return (torch.minimum(a[..., :, None], b[..., None, :])
            - torch.maximum(a0[..., :, None], b0[..., None, :])).clamp(min=0)


def solve_reroute(lam: torch.Tensor, u: torch.Tensor, *, locality: bool = True,
                  rack_size: int | None = None) -> torch.Tensor:
    """Quota decomposition Q (S5.2): locality first, then NW-corner residual.

    Mirrors the flat tier of ``repro.core.planner.solve_reroute``; both
    marginals are exact: ``Q.sum(-1) == lam`` and ``Q.sum(0).T == u``.
    """
    if rack_size is not None:
        raise ValueError("rack_size: the rack-local tier is not ported yet")
    lam = lam.to(_I64)
    u = u.to(_I64)
    R, _E = lam.shape
    demand = lam.T
    quota = u
    local = None
    if locality:
        local = torch.minimum(demand, quota)
        demand = demand - local
        quota = quota - local
    q = _nw_corner(demand, quota).permute(1, 0, 2)         # (R_src, E, R_dst)
    if locality:
        eye = torch.eye(R, dtype=_I64, device=lam.device)
        q = q + local.T[:, :, None] * eye[:, None, :]
    return q.contiguous()


def slot_assignment(u: torch.Tensor, home: torch.Tensor, n_slot: int) -> torch.Tensor:
    """(R, N_slot) expert id per redundant slot (expert-id order), -1 empty."""
    E, R = u.shape
    dev = u.device
    ranks = torch.arange(R, dtype=_I64, device=dev)
    is_replica = (u.T > 0) & (home.to(_I64)[None, :] != ranks[:, None])
    pos = torch.cumsum(is_replica.to(_I64), dim=1) - 1
    # Non-replicas (and replicas past the budget) park in spare column n_slot.
    pos = torch.where(is_replica, pos, n_slot).clamp(max=n_slot)
    ids = torch.where(is_replica, torch.arange(E, dtype=_I64, device=dev), -1)
    buf = torch.full((R, n_slot + 1), -1, dtype=_I64, device=dev)
    # Only the parked column receives duplicate writes, and it is dropped.
    buf.scatter_(1, pos, ids)
    return buf[:, :n_slot]


def occurrence_index(expert_ids: torch.Tensor) -> torch.Tensor:
    """j-th occurrence index of each item within its expert group (stable)."""
    n = expert_ids.shape[0]
    dev = expert_ids.device
    order = torch.sort(expert_ids, stable=True).indices
    sorted_e = expert_ids[order]
    idx = torch.arange(n, dtype=_I64, device=dev)
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    is_start[1:] = sorted_e[1:] != sorted_e[:-1]
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    occ = torch.empty(n, dtype=_I64, device=dev)
    occ[order] = idx - seg_start
    return occ


def cumulative_quota(q_or_u: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum over the trailing (destination-rank) axis."""
    return torch.cumsum(q_or_u.to(_I64), dim=-1)


def token_targets(expert_ids: torch.Tensor, q_row: torch.Tensor | None = None,
                  *, valid: torch.Tensor | None = None,
                  cumq: torch.Tensor | None = None,
                  occ: torch.Tensor | None = None) -> torch.Tensor:
    """Per-item destination rank via cumulative-quota lookup (S5.2).

    Mirrors ``repro.core.planner.token_targets``: item j of expert e goes to
    the first rank whose cumulative quota exceeds j.
    """
    if cumq is None:
        if q_row is None:
            raise ValueError("token_targets needs q_row or cumq")
        cumq = cumulative_quota(q_row)
    j = occurrence_index(expert_ids) if occ is None else occ
    cum_rows = cumq[expert_ids]                               # (T, R)
    tgt = (cum_rows <= j[:, None]).sum(dim=1).clamp(max=cumq.shape[1] - 1)
    if valid is not None:
        tgt = torch.where(valid, tgt, -1)
    return tgt


def solve_plan(lam: torch.Tensor, home: torch.Tensor, *, n_slot: int,
               u_min: int = 1, locality: bool = True,
               max_replicas_per_expert: int | None = None,
               probe_parallelism: int = 1, rack_size: int | None = None,
               health_weight: torch.Tensor | None = None,
               demand_tiebreak: bool = False,
               load_bound: int | None = None) -> Plan:
    """Full Alg. 1: replication + reroute + slot map + imbalance metrics.

    Mirrors ``repro.core.planner.solve_plan`` on the flat tier
    (``load_bound``: see :func:`solve_replication`).
    """
    _flat_only(rack_size, health_weight, demand_tiebreak, probe_parallelism)
    lam = lam.to(_I64)
    home = home.to(_I64)
    u, tau = solve_replication(lam, home, n_slot=n_slot, u_min=u_min,
                               max_replicas_per_expert=max_replicas_per_expert,
                               load_bound=load_bound)
    q = solve_reroute(lam, u, locality=locality)
    return _plan_from(lam, u, q, tau, home, n_slot)


def _plan_from(lam, u, q, tau, home, n_slot: int) -> Plan:
    """Assemble a :class:`Plan` from solved tables (shared with the balancer)."""
    R = lam.shape[0]
    hosted = (u.T > 0) | torch.nn.functional.one_hot(home, R).T.bool()
    ell = _rank_load(lam.sum(dim=0), home, R)
    return Plan(u=u, q=q, x=slot_assignment(u, home, n_slot), tau=tau,
                hosted=hosted, pre_max=ell.max(), post_max=u.sum(dim=0).max(),
                cum_q=cumulative_quota(q), cum_u=cumulative_quota(u))
