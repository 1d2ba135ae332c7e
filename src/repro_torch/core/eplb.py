"""EPLB and EPLB+ baselines (paper S8.1), adapted to the fixed-mains layout.

Mirrors ``repro.core.eplb``.  EPLB (DeepSeek's Expert Parallelism Load
Balancer) decides *replica counts* from a load estimate and packs
instances greedily; token reroute is a separate round-robin split.  The
paper's baselines:

  * **EPLB**  -- replica placement from *historical* (EMA) load, refreshed
    every ``interval`` steps; round-robin reroute on realized load.
  * **EPLB+** -- same placement algorithm but fed the *exact* post-gating
    load each microbatch (isolates quota-solving benefit from load
    fidelity); round-robin reroute.

Main experts are immutable (the UltraEP layout), so EPLB here only chooses
replicas into the ``N_slot`` redundant slots -- the same decision space the
quota planner gets.

The numpy half (:func:`eplb_replication`, :func:`round_robin_reroute`,
:class:`LoadEMA`, :func:`eplb_plan`) is a copy of the reference's, for host
tools.  The device half runs where its tensors live:
:func:`eplb_replication_dev` is the greedy placement through the
hand-written kernel :mod:`repro_torch.kernels.eplb_place` on a CUDA tensor
(its plain version on a CPU tensor), and :func:`round_robin_reroute_dev` is
the round-robin split as tensor code, so an ``eplb`` / ``eplb_plus`` solve
on the card reads nothing back.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.eplb_place.ops import eplb_place

__all__ = [
    "eplb_replication",
    "eplb_replication_dev",
    "round_robin_reroute",
    "round_robin_reroute_dev",
    "eplb_plan",
    "LoadEMA",
]

_I64 = torch.int64


def eplb_replication(
    lam_e: np.ndarray,
    home: np.ndarray,
    n_slot: int,
    max_replicas_per_expert: int | None = None,
) -> np.ndarray:
    """Greedy redundant-expert placement on estimated per-expert load.

    Repeatedly replicates the expert with the highest per-instance load
    (lam_e / |H(e)|) onto the admissible rank with the lowest estimated load,
    until all R*N_slot redundant slots are used or no placement is possible.

    Returns ``hosted``: (E, R) bool instance indicator (mains included).
    """
    lam_e = np.asarray(lam_e, dtype=np.float64)
    home = np.asarray(home, dtype=np.int64)
    E = lam_e.shape[0]
    R = int(home.max()) + 1 if home.size else 0
    max_rep = R if max_replicas_per_expert is None else max_replicas_per_expert + 1

    hosted = np.zeros((E, R), dtype=bool)
    hosted[np.arange(E), home] = True
    slots_used = np.zeros(R, dtype=np.int64)
    counts = np.ones(E, dtype=np.int64)
    eligible = np.ones(E, dtype=bool)
    budget = R * n_slot

    while budget > 0 and eligible.any():
        per_inst = np.where(eligible, lam_e / counts, -1.0)
        e = int(np.argmax(per_inst))
        if per_inst[e] <= 0:
            break
        adm = (slots_used < n_slot) & (~hosted[e])
        if not adm.any() or counts[e] >= max_rep:
            eligible[e] = False
            continue
        # Rank with the lowest estimated load (per-instance loads summed).
        est = hosted.T @ (lam_e / counts)  # (R,)
        est = np.where(adm, est, np.inf)
        t = int(np.argmin(est))
        hosted[e, t] = True
        slots_used[t] += 1
        counts[e] += 1
        budget -= 1
    return hosted


def round_robin_reroute(lam: np.ndarray, hosted: np.ndarray) -> np.ndarray:
    """EPLB-style round-robin token split across an expert's instances.

    ``q[r, e, t] = lam[r, e] // n_e`` plus one extra token to the first
    ``lam[r, e] % n_e`` hosts in an order rotated by the source rank (the
    standard deployment heuristic: spread remainders deterministically).
    """
    lam = np.asarray(lam, dtype=np.int64)
    hosted = np.asarray(hosted, dtype=bool)
    R, E = lam.shape
    q = np.zeros((R, E, R), dtype=np.int64)
    for e in range(E):
        hosts = np.where(hosted[e])[0]
        n = len(hosts)
        for r in range(R):
            v = lam[r, e]
            base, rem = divmod(v, n)
            q[r, e, hosts] = base
            if rem:
                start = r % n
                sel = hosts[(start + np.arange(rem)) % n]
                q[r, e, sel] += 1
    return q


def round_robin_reroute_dev(lam: torch.Tensor,
                            hosted: torch.Tensor) -> torch.Tensor:
    """The round-robin split as tensor code (mirrors
    ``repro.core.eplb.round_robin_reroute_jax``): (R, E) load and (E, R)
    hosts -> (R, E, R) int64, on the inputs' device, with no read back."""
    lam = lam.to(_I64)
    hosted = hosted.bool()                                   # (E, R)
    R, E = lam.shape
    n_e = hosted.sum(dim=1)                                  # (E,)
    n_safe = n_e.clamp(min=1)
    # Position of each host within its expert's host list (by rank id).
    pos = torch.cumsum(hosted.to(_I64), dim=1) - 1           # (E, R)
    base = (lam // n_safe[None, :])[:, :, None] * hosted[None, :, :]
    rem = (lam % n_safe[None, :])[:, :, None]                # (R_src, E, 1)
    start = torch.arange(R, dtype=_I64, device=lam.device)[:, None] % n_safe
    # Host h gets an extra token iff (pos - start) mod n_e < rem.
    rel = (pos[None, :, :] - start[:, :, None]) % n_safe[None, :, None]
    extra = (hosted[None, :, :] & (rel < rem)).to(_I64)
    return base + extra


def eplb_replication_dev(lam_e: torch.Tensor, home: torch.Tensor,
                         num_ranks: int, *, n_slot: int,
                         max_replicas_per_expert: int | None = None
                         ) -> torch.Tensor:
    """Greedy EPLB placement on the inputs' device (mirrors
    ``repro.core.eplb.eplb_replication_jit``): ``lam_e`` (E,) estimated
    load, cast to float32 as the reference casts it.  Returns hosted (E, R)
    bool."""
    max_rep = (num_ranks if max_replicas_per_expert is None
               else max_replicas_per_expert + 1)
    return eplb_place(lam_e.to(torch.float32).contiguous(),
                      home.to(_I64).contiguous(), num_ranks, n_slot=n_slot,
                      max_rep=max_rep)


class LoadEMA:
    """Exponential-moving-average per-expert load tracker (EPLB's estimator)."""

    def __init__(self, num_experts: int, decay: float = 0.9):
        self.decay = decay
        self.value = np.zeros(num_experts, dtype=np.float64)
        self._initialized = False

    def update(self, lam_e: np.ndarray) -> np.ndarray:
        lam_e = np.asarray(lam_e, dtype=np.float64)
        if not self._initialized:
            self.value = lam_e.copy()
            self._initialized = True
        else:
            self.value = self.decay * self.value + (1 - self.decay) * lam_e
        return self.value


def eplb_plan(
    lam: np.ndarray,
    home: np.ndarray,
    n_slot: int,
    lam_e_est: np.ndarray | None = None,
    max_replicas_per_expert: int | None = None,
):
    """Full EPLB(+) baseline plan: placement + round-robin reroute.

    ``lam_e_est=None`` means exact load (EPLB+); otherwise the stale estimate
    drives placement while reroute always acts on the realized ``lam``.
    Returns ``(u, q, hosted)``.
    """
    lam = np.asarray(lam, dtype=np.int64)
    est = lam.sum(axis=0).astype(np.float64) if lam_e_est is None else lam_e_est
    hosted = eplb_replication(est, home, n_slot, max_replicas_per_expert)
    q = round_robin_reroute(lam, hosted)
    u = q.sum(axis=0).astype(np.int64)  # (E, R) realized instance loads
    return u, q, hosted
