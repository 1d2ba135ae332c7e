"""Static verification layer: plan and schedule invariant checkers
(mirrors ``repro.analysis`` without its JAX linter; DESIGN.md S10).

* :mod:`repro_torch.analysis.plan_check` -- statically verifies a solved
  :class:`repro_torch.core.planner.Plan` against the paper's conservation
  and topology invariants (token conservation across reroute tiers, quota
  monotonicity, replica-placement validity, tier accounting), and the
  routing-side invariant of rack-limited gating.
* :mod:`repro_torch.analysis.sched_check` -- race/deadlock analysis of
  :class:`repro_torch.core.comm_plan.RelaySchedule` broadcast trees
  (dependency cycles, double writes, dangling relays, channel
  over-subscription).

Both are host-side numpy: a plan on the card is read back to be checked, so
the balancer's hook (:func:`plan_check.plan_verification`) is off by
default and reads nothing back then.
"""

from repro_torch.analysis.plan_check import (
    PlanViolationError,
    assert_plan_valid,
    hosted_matrix,
    plan_verification,
    verification_enabled,
    verify_plan,
)
from repro_torch.analysis.sched_check import verify_schedule
from repro_torch.analysis.violation import Violation, errors, format_violations

__all__ = [
    "Violation",
    "errors",
    "format_violations",
    "PlanViolationError",
    "assert_plan_valid",
    "hosted_matrix",
    "plan_verification",
    "verification_enabled",
    "verify_plan",
    "verify_schedule",
]
