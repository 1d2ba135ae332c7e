"""LPLB baseline (paper S8.1): EPLB placement + per-microbatch LP reroute.

Mirrors ``repro.core.lplb`` (host-side numpy).  LPLB keeps at most ONE
replica per expert (its overhead-control constraint) with placement
refreshed periodically from stale load, but re-solves the token reroute
each microbatch on the exact load.  The reroute is a fractional min-max
transportation problem, solved with a threshold binary search plus a
most-constrained-first greedy feasibility check (an exact LP would use
max-flow; the greedy is a documented approximation -- LPLB is a baseline,
not the contribution).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.eplb import eplb_replication

__all__ = ["waterfill_reroute", "lplb_plan"]


def _feasible(lam_e: np.ndarray, hosted: np.ndarray, tau: float):
    """Greedy transportation feasibility: can all load fit under cap tau?

    Experts with fewer hosts are more constrained, so they are assigned
    first; each expert fills its hosts' residual capacity largest-first.
    Returns (ok, u) with u the fractional assignment.
    """
    E, R = hosted.shape
    residual = np.full(R, float(tau))
    u = np.zeros((E, R), dtype=np.float64)
    n_hosts = hosted.sum(axis=1)
    order = np.lexsort((-lam_e, n_hosts))  # fewest hosts, then heaviest
    for e in order:
        need = float(lam_e[e])
        hosts = np.where(hosted[e])[0]
        # Fill the host with the largest residual first.
        for t in hosts[np.argsort(-residual[hosts], kind="stable")]:
            take = min(need, residual[t])
            u[e, t] += take
            residual[t] -= take
            need -= take
            if need <= 1e-9:
                break
        if need > 1e-9:
            return False, u
    return True, u


def waterfill_reroute(lam: np.ndarray, hosted: np.ndarray, iters: int = 32):
    """Min-max fractional reroute over fixed instance sets via binary search."""
    lam = np.asarray(lam, dtype=np.float64)
    lam_e = lam.sum(axis=0)
    R = lam.shape[0]
    lo = lam_e.sum() / R
    # Upper bound: everything on home-most-loaded configuration.
    per_rank_home = hosted.T @ lam_e  # loose but safe upper bound
    hi = float(per_rank_home.max())
    ok, best = _feasible(lam_e, hosted, hi)
    if not ok:  # greedy failed even at the loose bound; fall back
        best = (hosted.T * lam_e).T / np.maximum(hosted.sum(axis=1)[:, None], 1)
        return best, hi
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        ok, u = _feasible(lam_e, hosted, mid)
        if ok:
            best, hi = u, mid
        else:
            lo = mid
    return best, hi


def lplb_plan(
    lam: np.ndarray,
    home: np.ndarray,
    n_slot: int,
    lam_e_est: np.ndarray | None = None,
):
    """Full LPLB baseline: <=1 replica/expert placement + waterfill reroute.

    Returns ``(u, hosted, tau)`` with ``u`` integerized by largest-remainder
    per expert (row sums preserved exactly).
    """
    lam = np.asarray(lam, dtype=np.int64)
    est = lam.sum(axis=0).astype(np.float64) if lam_e_est is None else lam_e_est
    hosted = eplb_replication(est, home, n_slot, max_replicas_per_expert=1)
    u_frac, tau = waterfill_reroute(lam, hosted)

    # Integerize: floor + largest remainder per expert row.
    lam_e = lam.sum(axis=0)
    u = np.floor(u_frac).astype(np.int64)
    for e in range(lam.shape[1]):
        deficit = int(lam_e[e] - u[e].sum())
        if deficit > 0:
            frac = u_frac[e] - np.floor(u_frac[e])
            frac = np.where(hosted[e], frac, -1.0)
            top = np.argsort(-frac, kind="stable")[:deficit]
            u[e, top] += 1
    return u, hosted, tau
