"""Balancer mode dispatch: none / eplb / eplb_plus / lplb / ultraep / ideal.

Mirrors ``repro.core.balancer``.  The balancer is a function from the exact
post-gating load matrix to a :class:`repro_torch.core.planner.Plan`.  Modes
``none``, ``eplb``, ``eplb_plus`` and ``ultraep`` run on the load's device
and read nothing back (on the card: the plan-solve kernel for ``ultraep``,
the EPLB placement kernel for the EPLB modes).  ``eplb`` consumes a stale
estimate of the per-expert load (``lam_e_est``, e.g. a
:class:`repro_torch.core.eplb.LoadEMA` carried by the caller); ``lplb`` is
the documented host-side numpy mode: it reads the load back once a solve.
``ideal`` is realised at the gate (force-balanced router) and maps to
``none`` here.  Every mode's plan goes through the opt-in static check
:func:`repro_torch.analysis.plan_check.verify_solved`, as the reference's
``_checked`` does: off by default (no host read), on inside
:func:`repro_torch.analysis.plan_check.plan_verification`, where a plan
with an error-severity violation raises ``PlanViolationError``.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, get_args

import torch

from repro_torch.analysis import plan_check as _plan_check
from repro_torch.core import planner
from repro_torch.core.eplb import eplb_replication_dev, round_robin_reroute_dev
from repro_torch.core.planner import Plan

__all__ = ["BalancerConfig", "solve", "no_balance_plan", "MODES"]

_I64 = torch.int64

Mode = Literal["none", "eplb", "eplb_plus", "lplb", "ultraep", "ideal"]
MODES = get_args(Mode)


@dataclasses.dataclass(frozen=True)
class BalancerConfig:
    mode: Mode = "ultraep"
    n_slot: int = 2
    u_min: int = 1
    locality: bool = True
    max_replicas_per_expert: int | None = None
    probe_parallelism: int = 1       # >1 = beyond-paper k-ary probe search
    ema_decay: float = 0.9           # EPLB stale-load estimator (carried)
    rebalance_interval: int = 3      # EPLB refresh period (carried)

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown balancer mode: {self.mode!r}")
        if self.probe_parallelism < 1:
            raise ValueError(f"probe_parallelism={self.probe_parallelism} "
                             f"must be >= 1")


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
          lam_e_est: torch.Tensor | None = None,
          rack_size: int | None = None,
          health_weight: torch.Tensor | None = None,
          demand_tiebreak: bool = False,
          gate_tier_tokens: torch.Tensor | None = None,
          load_bound: int | None = None) -> Plan:
    """Dispatch on ``cfg.mode`` (mirrors ``repro.core.balancer.solve``).

    Every mode takes any R; ``ultraep`` at R > 1 solves on the card through
    the plan-solve kernel, which needs ``load_bound`` (see
    :func:`repro_torch.core.planner.solve_replication`).  ``lam_e_est``
    feeds the stale estimator of ``mode="eplb"`` (ignored elsewhere; None
    falls back to the exact load, which is ``eplb_plus``).  ``rack_size``
    switches on the rack-aware solve and every plan's tier volumes (the
    EPLB baselines keep their round-robin reroute and only report the
    tiers; ``lplb`` decomposes its quotas with the rack-local tier).
    ``health_weight`` ((R,) per-rank relative throughput) is honoured by
    ``ultraep`` only: the baselines are health-blind, as in the reference.
    ``demand_tiebreak`` (ultraep only) feeds the rack incidence of ``lam``
    into the replica placement; ``gate_tier_tokens`` is stamped on every
    mode's plan."""
    lam = lam.to(_I64)
    home = home.to(_I64)
    R, _E = lam.shape

    def _checked(plan: Plan, *, health: torch.Tensor | None = None) -> Plan:
        # Opt-in static verification: a no-op unless plan_verification()
        # is on, and skipped inside a CUDA-graph capture.
        _plan_check.verify_solved(plan, lam=lam, home=home,
                                  rack_size=rack_size, mode=cfg.mode,
                                  health_weight=health)
        return plan

    if cfg.mode in ("none", "ideal"):
        return _checked(no_balance_plan(lam, home, cfg.n_slot, rack_size,
                                        gate_tier_tokens))
    if cfg.mode == "ultraep":
        return _checked(planner.solve_plan(
            lam, home, n_slot=cfg.n_slot, u_min=cfg.u_min,
            locality=cfg.locality,
            max_replicas_per_expert=cfg.max_replicas_per_expert,
            probe_parallelism=cfg.probe_parallelism, rack_size=rack_size,
            health_weight=health_weight, demand_tiebreak=demand_tiebreak,
            gate_tier_tokens=gate_tier_tokens, load_bound=load_bound),
            health=health_weight)
    if cfg.mode in ("eplb", "eplb_plus"):
        est = lam.sum(dim=0).to(torch.float32)
        if cfg.mode == "eplb" and lam_e_est is not None:
            est = torch.as_tensor(lam_e_est).to(lam.device, torch.float32)
        hosted = eplb_replication_dev(
            est, home, R, n_slot=cfg.n_slot,
            max_replicas_per_expert=cfg.max_replicas_per_expert)  # (E, R)
        q = round_robin_reroute_dev(lam, hosted)
        return _checked(_finish_plan(lam, q.sum(dim=0), q, home, cfg.n_slot,
                                     rack_size, gate_tier_tokens))
    # lplb: the documented host-side numpy mode (the one read back).
    import numpy as np

    from repro_torch.core.lplb import lplb_plan

    est = None
    if lam_e_est is not None:
        est = (lam_e_est.detach().cpu().numpy()
               if isinstance(lam_e_est, torch.Tensor)
               else np.asarray(lam_e_est))
    u_np, _hosted, _tau = lplb_plan(lam.cpu().numpy(), home.cpu().numpy(),
                                    cfg.n_slot, est)
    u = torch.from_numpy(u_np).to(lam.device)
    # LPLB's waterfill fixed the instance loads u; the source-wise split is
    # the NW-corner rule of the quota path.
    q = planner.solve_reroute(lam, u, locality=cfg.locality,
                              rack_size=rack_size)
    return _checked(_finish_plan(lam, u, q, home, cfg.n_slot, rack_size,
                                 gate_tier_tokens))
