"""Balancing-quality metrics (paper Table 4 / Fig. 6 / Fig. 15).

Mirrors ``repro.core.metrics``: host-side numpy.  The inputs may be numpy
arrays or tensors on any device; a tensor is read back to the host, which
is the point of a report.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["BalanceReport", "imbalance", "report"]


def _host(a, dtype) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=dtype)


def imbalance(rank_loads) -> float:
    """Max/mean per-rank load ratio (the paper's rank-level imbalance)."""
    rank_loads = _host(rank_loads, np.float64)
    mean = rank_loads.mean()
    if mean == 0:
        return 1.0
    return float(rank_loads.max() / mean)


@dataclasses.dataclass
class BalanceReport:
    """Table-4 style summary for one solved plan."""

    pre_imbalance: float       # max/mean of home-rank loads
    post_imbalance: float      # max/mean of post-reroute rank loads
    total_instances: int       # sum_e |H(e)|  (mains + replicas with quota)
    max_fanout: int            # max_e |H(e)|
    slots_used: int            # number of materialised replicas
    inflight_token_ratio: float  # fraction of routed tokens leaving their source


def report(lam, u, home) -> BalanceReport:
    """Compute the Table-4 metrics from (Lambda, U, home)."""
    lam = _host(lam, np.int64)     # (R, E)
    u = _host(u, np.int64)         # (E, R)
    home = _host(home, np.int64)
    R, E = lam.shape

    lam_e = lam.sum(axis=0)
    ell = np.zeros(R, dtype=np.int64)
    np.add.at(ell, home, lam_e)
    post = u.sum(axis=0)

    hosts = (u > 0).astype(np.int64)
    hosts[np.arange(E), home] = 1  # mains always count as instances
    n_hosts = hosts.sum(axis=1)
    replicas = hosts.copy()
    replicas[np.arange(E), home] = 0

    # In-flight = tokens whose destination instance is off their source rank.
    # Local absorption: each source r keeps min(lam[r, e], u[e, r]) per expert.
    local = np.minimum(lam, u.T).sum()
    total = lam.sum()
    inflight = 1.0 if total == 0 else float(total - local) / float(total)

    return BalanceReport(
        pre_imbalance=imbalance(ell),
        post_imbalance=imbalance(post),
        total_instances=int(n_hosts.sum()),
        max_fanout=int(n_hosts.max()),
        slots_used=int(replicas.sum()),
        inflight_token_ratio=inflight,
    )
