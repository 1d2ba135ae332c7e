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
                 home: torch.Tensor, n_slot: int, rack_size: int | None = None,
                 gate_tier_tokens: torch.Tensor | None = None) -> Plan:
    """Mirrors ``repro.core.balancer._finish_plan``: tau = post-balance max."""
    return planner._plan_from(lam, u.to(_I64), q.to(_I64),
                              u.sum(dim=0).max(), home, n_slot, rack_size,
                              gate_tier_tokens)


def no_balance_plan(lam: torch.Tensor, home: torch.Tensor, n_slot: int,
                    rack_size: int | None = None,
                    gate_tier_tokens: torch.Tensor | None = None) -> Plan:
    """Identity plan: every token goes to its expert's home rank (with
    ``rack_size``, the plan also reports its tier volumes)."""
    lam = lam.to(_I64)
    home = home.to(_I64)
    R, _E = lam.shape
    onehot = torch.nn.functional.one_hot(home, R).to(_I64)        # (E, R)
    u = onehot * lam.sum(dim=0)[:, None]
    q = lam[:, :, None] * onehot[None, :, :]
    return _finish_plan(lam, u, q, home, n_slot, rack_size, gate_tier_tokens)


def solve(lam: torch.Tensor, home: torch.Tensor, cfg: BalancerConfig, *,
          rack_size: int | None = None, demand_tiebreak: bool = False,
          gate_tier_tokens: torch.Tensor | None = None,
          load_bound: int | None = None) -> Plan:
    """Dispatch on ``cfg.mode`` (mirrors ``repro.core.balancer.solve``).

    Every mode takes any R; ``ultraep`` at R > 1 solves on the card through
    the plan-solve kernel, which needs ``load_bound`` (see
    :func:`repro_torch.core.planner.solve_replication`).  ``rack_size``
    switches on the rack-aware solve and every plan's tier volumes;
    ``demand_tiebreak`` (ultraep only) feeds the rack incidence of ``lam``
    into the replica placement; ``gate_tier_tokens`` is stamped on every
    mode's plan."""
    lam = lam.to(_I64)
    home = home.to(_I64)
    if cfg.mode in ("none", "ideal"):
        return no_balance_plan(lam, home, cfg.n_slot, rack_size,
                               gate_tier_tokens)
    return planner.solve_plan(
        lam, home, n_slot=cfg.n_slot, u_min=cfg.u_min, locality=cfg.locality,
        max_replicas_per_expert=cfg.max_replicas_per_expert,
        rack_size=rack_size, demand_tiebreak=demand_tiebreak,
        gate_tier_tokens=gate_tier_tokens, load_bound=load_bound)
