"""UltraEP quota-driven replication planner (paper Alg. 1).

Mirrors ``repro.core.planner``: the same greedy feasibility oracle,
threshold search (bisection, or the k-ary round at ``probe_parallelism``
P > 1), health-weighted capacities, locality-first NW-corner reroute and
slot assignment, so the plan tables are integer-identical to the JAX solve
(and at P = 1 with no health weights to the numpy oracle
``repro.core.ref_planner``).

Health weights (``health_weight``, (R,) per-rank relative throughput,
:class:`repro_torch.core.health.RankHealth`): normalised so the fastest
rank is 1.0, each probe caps rank r at ``floor(f32(tau) * w_r)``, so a
half-speed rank is packed to about half the quota and a quarantined rank
(weight 0) drains to zero; tau is then in full-speed-rank units.  Every
rank of a group must pass the same vector, as every rank must see the
same load, for the ranks to solve the same plan.

The rack tier (``rack_size``, ranks per rack of a two-level topology,
DESIGN.md S9) is the reference's: exact slack ties in the oracle break
toward racks that demand the expert (``demand_tiebreak``, DESIGN.md S14),
then toward the expert's home rack; the reroute gains a rack-local
NW-corner tier before the global one; and the plan carries its token and
replica volumes by fabric tier.  With one rack every bonus is uniform and
the plan is the flat one, bit for bit.

Control flow.  JAX runs both loops as ``lax.while_loop`` on the device.
Here they are one launch of a hand-written kernel on a CUDA tensor
(:mod:`repro_torch.kernels.plan_solve`, the paper's GPU-native solve,
S5.3; at P > 1 its warps probe P thresholds at once, the paper's
warp-parallel probing) and, on a CPU tensor, its plain version: Python
loops whose conditions read scalars.  With one EP rank the interval is
empty from the start (``tau_lo = ceil(total / 1) = max(ell) = tau_hi``;
with health weights the one weight normalises to 1 and ``tau_lo = total =
tau_hi``), so the solve returns the home quota and ``tau = total`` with no
launch and no read.
Everything around the loops (the expert order, the reroute, the slot map,
the cumsums) is tensor code, so a solve on the card reads nothing back.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.plan_solve.ops import plan_solve

__all__ = ["Plan", "solve_replication", "solve_reroute", "solve_plan",
           "slot_assignment", "token_targets", "occurrence_index",
           "cumulative_quota", "token_tier_volumes", "replica_tier_volumes"]

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
    # Rack-aware solves (rack_size set): token items and replica instances
    # by fabric tier.
    tier_tokens: torch.Tensor | None = None    # (3,) [local, intra, inter]
    tier_replicas: torch.Tensor | None = None  # (2,) [intra, inter]
    # Rack-limited routing: the gate's (3,) deduplicated payload copies
    # against the home placement, before any reroute (the at-gate twin of
    # tier_tokens; repro_torch.moe.gating.rack_copy_volumes).
    gate_tier_tokens: torch.Tensor | None = None  # (3,) [local, intra, inter]


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


def _check_rack_size(rack_size: int | None, R: int) -> None:
    if rack_size is not None and (rack_size < 1 or R % rack_size != 0):
        raise ValueError(f"rack_size={rack_size} must divide R={R}")


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
    the kernel's int32 arithmetic takes totals below 2^31 only (below
    2^31 / 2, or / 4 with ``demand_tiebreak``, in rack mode: the score
    scales the slack; below 2^31 / P at ``probe_parallelism`` P and 2^30
    with ``health_weight``).  ``rack_size``, ``demand_tiebreak`` and
    ``health_weight``: see the module's notes.
    """
    lam = lam.to(_I64)
    home = home.to(_I64)
    R, E = lam.shape
    if E % R != 0:
        raise ValueError(f"E={E} must be a multiple of R={R}")
    _check_rack_size(rack_size, R)
    max_rep = R if max_replicas_per_expert is None else max_replicas_per_expert

    lam_e = lam.sum(dim=0)
    if R == 1:
        # The interval is empty: the home quota, tau = total, no read.
        return _home_quota(lam_e, home, R), lam_e.sum()
    ell = _rank_load(lam_e, home, R)
    rank_experts = _expert_order(lam_e, home, R)
    demand = demand_tiebreak and rack_size is not None
    return plan_solve(lam_e, ell, home, rank_experts, n_slot=n_slot,
                      u_min=u_min, max_replicas_per_expert=max_rep,
                      load_bound=load_bound, rack_size=rack_size,
                      lam=lam.contiguous() if demand else None,
                      health_weight=health_weight,
                      probe_parallelism=probe_parallelism)


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

    Mirrors ``repro.core.planner.solve_reroute``; both marginals are exact:
    ``Q.sum(-1) == lam`` and ``Q.sum(0).T == u``.  ``rack_size`` inserts the
    rack-local tier between the rank-local step and the global residual:
    per expert and rack, residual demand is NW-corner matched against
    residual quota inside the rack before any flow crosses racks.
    """
    lam = lam.to(_I64)
    u = u.to(_I64)
    R, E = lam.shape
    _check_rack_size(rack_size, R)
    demand = lam.T
    quota = u
    local = None
    if locality:
        local = torch.minimum(demand, quota)
        demand = demand - local
        quota = quota - local
    q_intra = None
    if rack_size is not None:
        L = rack_size
        G = R // L
        fill_g = _nw_corner(demand.reshape(E, G, L),
                            quota.reshape(E, G, L))         # (E, G, L, L)
        demand = demand - fill_g.sum(dim=-1).reshape(E, R)
        quota = quota - fill_g.sum(dim=-2).reshape(E, R)
        # Rack blocks onto the (R_src, R_dst) diagonal of racks.
        eye_g = torch.eye(G, dtype=_I64, device=lam.device)
        q_intra = (eye_g[None, :, None, :, None]
                   * fill_g[:, :, :, None, :]).reshape(E, R, R)
    fill = _nw_corner(demand, quota)                        # (E, R_src, R_dst)
    if q_intra is not None:
        fill = fill + q_intra
    q = fill.permute(1, 0, 2)                               # (R_src, E, R_dst)
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


def token_tier_volumes(q: torch.Tensor, rack_size: int) -> torch.Tensor:
    """(3,) token items by fabric tier: [local, intra_rack, inter_rack].

    Mirrors ``repro.core.planner.token_tier_volumes``; ``q`` is the
    (R_src, E, R_dst) reroute split."""
    R = q.shape[0]
    per_pair = q.to(_I64).sum(dim=1)                         # (R_src, R_dst)
    ranks = torch.arange(R, dtype=_I64, device=q.device)
    same_rank = ranks[:, None] == ranks[None, :]
    same_rack = (ranks[:, None] // rack_size) == (ranks[None, :] // rack_size)
    zero = torch.zeros((), dtype=_I64, device=q.device)
    return torch.stack([
        torch.where(same_rank, per_pair, zero).sum(),
        torch.where(same_rack & ~same_rank, per_pair, zero).sum(),
        torch.where(~same_rack, per_pair, zero).sum()])


def replica_tier_volumes(u: torch.Tensor, home: torch.Tensor,
                         rack_size: int) -> torch.Tensor:
    """(2,) replica instances by tier: [intra_rack, inter_rack].

    Mirrors ``repro.core.planner.replica_tier_volumes``: each off-home
    instance with positive quota is one weight transfer from its home."""
    E, R = u.shape
    ranks = torch.arange(R, dtype=_I64, device=u.device)
    home = home.to(_I64)
    is_rep = (u.T > 0) & (home[None, :] != ranks[:, None])   # (R, E)
    same_rack = (ranks[:, None] // rack_size) == (home[None, :] // rack_size)
    return torch.stack([(is_rep & same_rack).sum(),
                        (is_rep & ~same_rack).sum()])


def solve_plan(lam: torch.Tensor, home: torch.Tensor, *, n_slot: int,
               u_min: int = 1, locality: bool = True,
               max_replicas_per_expert: int | None = None,
               probe_parallelism: int = 1, rack_size: int | None = None,
               health_weight: torch.Tensor | None = None,
               demand_tiebreak: bool = False,
               gate_tier_tokens: torch.Tensor | None = None,
               load_bound: int | None = None) -> Plan:
    """Full Alg. 1: replication + reroute + slot map + imbalance metrics.

    Mirrors ``repro.core.planner.solve_plan`` (``load_bound``: see
    :func:`solve_replication`).  ``rack_size`` switches on the rack-aware
    solve and the plan's tier volumes; ``gate_tier_tokens`` is stamped on
    the plan as given.
    """
    lam = lam.to(_I64)
    home = home.to(_I64)
    u, tau = solve_replication(lam, home, n_slot=n_slot, u_min=u_min,
                               max_replicas_per_expert=max_replicas_per_expert,
                               probe_parallelism=probe_parallelism,
                               rack_size=rack_size,
                               health_weight=health_weight,
                               demand_tiebreak=demand_tiebreak,
                               load_bound=load_bound)
    q = solve_reroute(lam, u, locality=locality, rack_size=rack_size)
    return _plan_from(lam, u, q, tau, home, n_slot, rack_size,
                      gate_tier_tokens)


def _plan_from(lam, u, q, tau, home, n_slot: int, rack_size=None,
               gate_tier_tokens=None) -> Plan:
    """Assemble a :class:`Plan` from solved tables (shared with the balancer)."""
    R = lam.shape[0]
    hosted = (u.T > 0) | torch.nn.functional.one_hot(home, R).T.bool()
    ell = _rank_load(lam.sum(dim=0), home, R)
    return Plan(u=u, q=q, x=slot_assignment(u, home, n_slot), tau=tau,
                hosted=hosted, pre_max=ell.max(), post_max=u.sum(dim=0).max(),
                cum_q=cumulative_quota(q), cum_u=cumulative_quota(u),
                tier_tokens=(None if rack_size is None
                             else token_tier_volumes(q, rack_size)),
                tier_replicas=(None if rack_size is None
                               else replica_tier_volumes(u, home, rack_size)),
                gate_tier_tokens=gate_tier_tokens)
