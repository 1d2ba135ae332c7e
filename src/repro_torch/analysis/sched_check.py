"""Static race/deadlock analysis of relay broadcast schedules (mirrors
``repro.analysis.sched_check``; DESIGN.md S10).

``verify_schedule`` inspects a
:class:`repro_torch.core.comm_plan.RelaySchedule`
(the load-aware relay / rack-relay trees of paper S6.2) *before* it is
simulated or lowered, catching the schedule bugs that silently corrupt
replica state at production rate:

* ``deadlock-cycle``      -- a cycle in the edge dependency graph: every
                             edge on it waits forever (``simulate`` would
                             silently skip them, a real runtime would hang).
* ``dangling-dep``        -- a stage-two edge with no (or an out-of-range)
                             dependency: nothing ever wakes it.
* ``relay-race``          -- an edge whose source is not the expert's home
                             and whose dependency does not deliver that
                             expert to that source first: the relay would
                             forward bytes it never received.
* ``double-write``        -- two edges delivering the same expert to the
                             same rank: concurrent writers to one replica
                             buffer (and wasted wire bytes).
* ``self-send``           -- an edge with ``src == dst``.
* ``unreachable-dest``    -- (with ``hosted``) a planned replica that no
                             edge ever delivers: the slot would serve
                             garbage weights.
* ``volume-accounting``   -- ``schedule.send_volume`` disagrees with the
                             per-edge byte sums the relay builder priced its
                             decisions on.
* ``channel-oversubscription`` -- (warn) one rank's send channel carries
                             more than ``oversubscription_factor`` x the mean
                             busy time under the (per-tier) alpha-beta link
                             model: the schedule serialises on that channel
                             (the exact failure mode relay trees exist to
                             avoid, Fig. 16).

The checker is duck-typed over ``schedule.edges`` / ``schedule.send_volume``
and imports nothing from :mod:`repro_torch.core`, so it can analyse hand-built
schedules in tests as easily as planner output.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch.analysis.violation import Violation, errors, format_violations

__all__ = ["verify_schedule", "assert_schedule_valid",
           "ScheduleViolationError"]


class ScheduleViolationError(AssertionError):
    """A relay schedule failed static verification."""

    def __init__(self, violations: list[Violation]):
        self.violations = violations
        super().__init__(
            f"{len(violations)} schedule violation(s):\n"
            + format_violations(violations)
        )


def _find_cycle(deps: list[int]) -> list[int] | None:
    """Return one dependency cycle (as edge indices) if any exists."""
    n = len(deps)
    color = [0] * n  # 0 = white, 1 = on stack, 2 = done
    for start in range(n):
        if color[start] != 0:
            continue
        path = []
        node = start
        while True:
            if color[node] == 1:
                return path[path.index(node):]
            if color[node] == 2:
                break
            color[node] = 1
            path.append(node)
            nxt = deps[node]
            if nxt < 0 or nxt >= n:
                break
            node = nxt
        for v in path:
            color[v] = 2
    return None


def verify_schedule(
    schedule: Any,
    *,
    home: np.ndarray,
    hosted: np.ndarray | None = None,
    topology: Any = None,
    alpha: float = 2e-6,
    link_bandwidth: float = 100e9,
    oversubscription_factor: float = 4.0,
) -> list[Violation]:
    """Statically verify a relay schedule; returns all violations found.

    Args:
      schedule: a :class:`repro_torch.core.comm_plan.RelaySchedule` (duck-typed:
        ``edges`` with src/dst/expert/nbytes/stage/depends_on, and
        ``send_volume``).
      home: (E,) home rank per expert.
      hosted: optional (E, R) bool instance indicator (the comm-planner
        orientation; use :func:`repro_torch.analysis.plan_check.hosted_matrix` on a
        Plan).  Enables the completeness check that every planned replica
        receives exactly one delivery.
      topology: optional :class:`repro_torch.core.topology.Topology` for the
        per-tier link model of the over-subscription check; the flat
        ``alpha``/``link_bandwidth`` model is used otherwise.
      oversubscription_factor: warn when one rank's send-channel busy time
        exceeds this multiple of the mean busy time of active senders.
    """
    out: list[Violation] = []
    edges = list(schedule.edges)
    home = np.asarray(home, dtype=np.int64)
    n = len(edges)

    num_ranks = len(schedule.send_volume)
    deps = [e.depends_on for e in edges]

    # --- dependency sanity -------------------------------------------------
    for i, e in enumerate(edges):
        if e.depends_on >= n:
            out.append(Violation(
                "dangling-dep",
                f"edge {i} depends on #{e.depends_on} but the schedule has "
                f"only {n} edges"))
        if e.stage == 1 and e.depends_on < 0:
            out.append(Violation(
                "dangling-dep",
                f"stage-two edge {i} (expert {e.expert} "
                f"{e.src}->{e.dst}) has no dependency: nothing wakes it"))
        if e.src == e.dst:
            out.append(Violation(
                "self-send",
                f"edge {i} sends expert {e.expert} from rank {e.src} to "
                "itself"))
        if not (0 <= e.src < num_ranks and 0 <= e.dst < num_ranks):
            out.append(Violation(
                "shape",
                f"edge {i} endpoints ({e.src}->{e.dst}) outside "
                f"[0, {num_ranks})"))

    cycle = _find_cycle([d if 0 <= d < n else -1 for d in deps])
    if cycle is not None:
        out.append(Violation(
            "deadlock-cycle",
            f"dependency cycle over edges {cycle}: every edge on it waits "
            "for its own completion"))

    # --- relay data-flow: a non-home sender must have received first -------
    for i, e in enumerate(edges):
        if e.src == home[e.expert]:
            continue
        dep = edges[e.depends_on] if 0 <= e.depends_on < n else None
        if dep is None:
            out.append(Violation(
                "relay-race",
                f"edge {i} sends expert {e.expert} from non-home rank "
                f"{e.src} with no dependency delivering it there"))
        elif dep.dst != e.src or dep.expert != e.expert:
            out.append(Violation(
                "relay-race",
                f"edge {i} (expert {e.expert} from rank {e.src}) depends on "
                f"edge {e.depends_on} which delivers expert {dep.expert} to "
                f"rank {dep.dst}: the relay would forward bytes it never "
                "received"))

    # --- double writes -----------------------------------------------------
    seen: dict[tuple[int, int], int] = {}
    for i, e in enumerate(edges):
        key = (e.expert, e.dst)
        if key in seen:
            out.append(Violation(
                "double-write",
                f"edges {seen[key]} and {i} both deliver expert {e.expert} "
                f"to rank {e.dst}: concurrent writers to one replica "
                "buffer"))
        else:
            seen[key] = i

    # --- completeness vs the plan ------------------------------------------
    if hosted is not None:
        hosted = np.asarray(hosted, dtype=bool)
        E, R = hosted.shape
        delivered = np.zeros((E, R), dtype=bool)
        for e in edges:
            delivered[e.expert, e.dst] = True
        missing = hosted.copy()
        missing[np.arange(E), home] = False     # mains never move
        missing &= ~delivered
        if missing.any():
            ee, tt = np.argwhere(missing)[0]
            out.append(Violation(
                "unreachable-dest",
                f"{int(missing.sum())} planned replica(s) receive no "
                f"delivery, e.g. expert {int(ee)} on rank {int(tt)}: the "
                "slot would serve garbage weights"))
        extra = delivered & ~hosted
        if extra.any():
            ee, tt = np.argwhere(extra)[0]
            out.append(Violation(
                "unreachable-dest",
                f"{int(extra.sum())} delivery(ies) target ranks hosting no "
                f"instance, e.g. expert {int(ee)} -> rank {int(tt)}"))

    # --- volume accounting --------------------------------------------------
    vol = np.zeros(num_ranks, dtype=np.int64)
    for e in edges:
        if 0 <= e.src < num_ranks:
            vol[e.src] += e.nbytes
    if not np.array_equal(vol, np.asarray(schedule.send_volume,
                                          dtype=np.int64)):
        out.append(Violation(
            "volume-accounting",
            "schedule.send_volume disagrees with per-edge byte sums: the "
            "relay builder priced its placement on wrong numbers"))

    # --- channel over-subscription (alpha-beta busy time) -------------------
    busy = np.zeros(num_ranks)
    for e in edges:
        if not (0 <= e.src < num_ranks):
            continue
        if topology is not None:
            a, beta = topology.link(e.src, e.dst)
        else:
            a, beta = alpha, link_bandwidth
        busy[e.src] += a + e.nbytes / beta
    active = busy[busy > 0]
    if active.size >= 2:
        worst = int(np.argmax(busy))
        ratio = busy[worst] / active.mean()
        if ratio > oversubscription_factor:
            out.append(Violation(
                "channel-oversubscription",
                f"rank {worst}'s send channel is busy "
                f"{ratio:.1f}x the active-sender mean "
                f"({busy[worst] * 1e3:.2f} ms): the schedule serialises on "
                "one channel",
                severity="warn"))
    return out


def assert_schedule_valid(schedule: Any, **kw) -> None:
    """Raise :class:`ScheduleViolationError` on error-severity violations."""
    bad = errors(verify_schedule(schedule, **kw))
    if bad:
        raise ScheduleViolationError(bad)
