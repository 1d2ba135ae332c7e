"""Balancer mode dispatch: none / ideal / ultraep.

Mirrors ``repro.core.balancer`` for the modes this slice carries.  ``ideal``
is realised at the gate (force-balanced router) and maps to ``none`` here.
The EPLB/LPLB baselines and the plan-check hook are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch.core import planner
from repro_torch.core.planner import Plan

__all__ = ["BalancerConfig", "solve", "no_balance_plan"]

_I64 = torch.int64

Mode = Literal["none", "ultraep", "ideal"]


@dataclasses.dataclass(frozen=True)
class BalancerConfig:
    mode: Mode = "ultraep"
    n_slot: int = 2
    u_min: int = 1
    locality: bool = True
    max_replicas_per_expert: int | None = None

    def __post_init__(self):
        if self.mode not in ("none", "ultraep", "ideal"):
            raise ValueError(f"unknown or unported balancer mode: {self.mode!r}")


def _finish_plan(lam: torch.Tensor, u: torch.Tensor, q: torch.Tensor,
                 home: torch.Tensor, n_slot: int) -> Plan:
    """Mirrors ``repro.core.balancer._finish_plan``: tau = post-balance max."""
    return planner._plan_from(lam, u.to(_I64), q.to(_I64),
                              u.sum(dim=0).max(), home, n_slot)


def no_balance_plan(lam: torch.Tensor, home: torch.Tensor, n_slot: int) -> Plan:
    """Identity plan: every token goes to its expert's home rank."""
    lam = lam.to(_I64)
    home = home.to(_I64)
    R, _E = lam.shape
    onehot = torch.nn.functional.one_hot(home, R).to(_I64)        # (E, R)
    u = onehot * lam.sum(dim=0)[:, None]
    q = lam[:, :, None] * onehot[None, :, :]
    return _finish_plan(lam, u, q, home, n_slot)


def solve(lam: torch.Tensor, home: torch.Tensor, cfg: BalancerConfig, *,
          load_bound: int | None = None) -> Plan:
    """Dispatch on ``cfg.mode`` (mirrors ``repro.core.balancer.solve``).

    Every mode takes any R; ``ultraep`` at R > 1 solves on the card through
    the plan-solve kernel, which needs ``load_bound`` (see
    :func:`repro_torch.core.planner.solve_replication`)."""
    lam = lam.to(_I64)
    home = home.to(_I64)
    if cfg.mode in ("none", "ideal"):
        return no_balance_plan(lam, home, cfg.n_slot)
    return planner.solve_plan(
        lam, home, n_slot=cfg.n_slot, u_min=cfg.u_min, locality=cfg.locality,
        max_replicas_per_expert=cfg.max_replicas_per_expert,
        load_bound=load_bound)
