"""Violation record shared by the plan and schedule checkers (mirrors
``repro.analysis.violation``)."""

from __future__ import annotations

import dataclasses
from typing import Iterable

__all__ = ["Violation", "errors", "warnings", "format_violations"]


@dataclasses.dataclass(frozen=True)
class Violation:
    """One invariant breach found by a static checker.

    ``severity`` is ``"error"`` for hard correctness invariants (a plan or
    schedule that would drop/duplicate tokens, deadlock, or race) and
    ``"warn"`` for documented discrepancies and efficiency hazards (e.g. the
    EPLB baselines' topology-blind reroute exceeding the rack-local-optimal
    inter-rack volume).
    """

    rule: str                 # kebab-case rule id, e.g. "token-conservation"
    message: str
    severity: str = "error"   # "error" | "warn"

    def __str__(self) -> str:
        return f"[{self.severity}] {self.rule}: {self.message}"


def errors(violations: Iterable[Violation]) -> list[Violation]:
    return [v for v in violations if v.severity == "error"]


def warnings(violations: Iterable[Violation]) -> list[Violation]:
    return [v for v in violations if v.severity == "warn"]


def format_violations(violations: Iterable[Violation]) -> str:
    return "\n".join(str(v) for v in violations)
