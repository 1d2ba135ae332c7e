"""Seeded chaos layer: inject fabric/planner faults at defined points.

Mirrors ``repro.fault.injector``; the corruption helpers take tensors.

The resilience layer (DESIGN.md S13) is only trustworthy if its failure
paths actually run, and real fabrics fail too rarely (and too
irreproducibly) to exercise them.  :class:`FaultInjector` is the
deterministic stand-in: a list of :class:`FaultSpec` windows, each firing a
specific fault kind on specific steps/layers/ranks, driven by a seeded RNG
so every test, tool, and benchmark run replays bit-identically.

Fault taxonomy (``FaultSpec.kind``):

* ``slow_rank``        -- rank computes/communicates at ``severity`` x speed
                          (feeds :meth:`FaultInjector.rank_speed`, which the
                          health model and comm simulator consume; no
                          exception is raised).
* ``transfer_flaky``   -- replica transfer raises a *transient*
                          :class:`TransferFault` for the first ``count``
                          attempts of each step, then succeeds (exercises
                          bounded retry + backoff).
* ``transfer_corrupt`` -- replica transfer delivers bit-corrupted (NaN)
                          payload rows (exercises stage-boundary screening).
* ``nan_payload``      -- a ``severity`` fraction of dispatched activation
                          rows turn NaN/Inf (exercises payload screening and
                          the drop counters).
* ``solve_fail``       -- the planner solve raises :class:`PlannerFault`
                          (exercises the last-good / no-balance ladder).
* ``solve_timeout``    -- the planner solve raises :class:`SolveTimeout`
                          (a :class:`PlannerFault` subtype: same ladder,
                          distinct counter).

Faults are injected at host level, at the call sites that decide what the
step runs, as in the reference; the corruption helpers return new tensors
(the corruption mask is a host-side constant of the step, drawn from numpy
and moved to the tensor's device: a copy to the card, no read back).  Under
``torch.distributed`` every process holds its own injector: the decisions
are deterministic in (seed, step, kind, layer) and the flaky-attempt
counts are per process, so the ranks agree when every rank builds the same
specs and advances the same steps.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["FAULT_KINDS", "FaultSpec", "FaultInjector", "PlannerFault",
           "SolveTimeout", "TransferFault"]

FAULT_KINDS = ("slow_rank", "transfer_flaky", "transfer_corrupt",
               "nan_payload", "solve_fail", "solve_timeout")


class PlannerFault(RuntimeError):
    """The balancer solve failed (injected or real); plan is unusable."""


class SolveTimeout(PlannerFault):
    """The balancer solve exceeded its deadline."""


class TransferFault(RuntimeError):
    """A replica/payload transfer failed.

    ``transient=True`` marks faults worth retrying (flaky link); permanent
    faults should degrade immediately.
    """

    def __init__(self, message: str, *, transient: bool = False):
        super().__init__(message)
        self.transient = transient


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault window: what to inject, where, and when.

    Args:
      kind: one of :data:`FAULT_KINDS`.
      rank: target rank for rank-scoped kinds (``slow_rank``); None = all.
      severity: kind-specific magnitude -- relative speed for ``slow_rank``
        (0.5 = half speed, 0.0 = dead), corrupted-row fraction for
        ``nan_payload`` / ``transfer_corrupt``.
      start_step / end_step: half-open active window ``[start, end)``;
        ``end_step=None`` = forever.
      layer: restrict to one MoE layer index; None = every layer.
      count: for ``transfer_flaky``, failed attempts per step before the
        transfer succeeds (default 1).
    """

    kind: str
    rank: int | None = None
    severity: float = 0.5
    start_step: int = 0
    end_step: int | None = None
    layer: int | None = None
    count: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of "
                f"{FAULT_KINDS}")
        if not 0.0 <= self.severity <= 1.0:
            raise ValueError(f"severity={self.severity} must be in [0, 1]")
        if self.count < 1:
            raise ValueError(f"count={self.count} must be >= 1")

    def active(self, step: int, layer: int | None = None) -> bool:
        if step < self.start_step:
            return False
        if self.end_step is not None and step >= self.end_step:
            return False
        if (self.layer is not None and layer is not None
                and layer != self.layer):
            return False
        return True


class FaultInjector:
    """Deterministic fault scheduler over a list of :class:`FaultSpec`.

    Drive it with :meth:`advance` once per step; query/raise at the defined
    injection points.  ``fired`` counts injections by kind, so tests and
    benchmarks can assert the chaos actually happened.
    """

    def __init__(self, specs=(), *, seed: int = 0):
        self.specs = tuple(specs)
        self.seed = int(seed)
        self.step = 0
        self.fired: dict[str, int] = {k: 0 for k in FAULT_KINDS}
        self._flaky_attempts: dict[int, int] = {}

    def advance(self, step: int) -> None:
        """Move the injector to ``step`` (resets per-step attempt state)."""
        self.step = int(step)
        self._flaky_attempts.clear()

    def _active(self, kind: str, layer: int | None = None):
        return [s for s in self.specs
                if s.kind == kind and s.active(self.step, layer)]

    def _rng(self, kind: str, layer: int | None) -> np.random.Generator:
        # Keyed per (seed, step, kind, layer): replayable regardless of how
        # many other injection points were queried first.
        return np.random.default_rng(
            (self.seed, self.step, FAULT_KINDS.index(kind),
             0 if layer is None else layer + 1))

    # ------------- injection points -------------

    def rank_speed(self, num_ranks: int) -> np.ndarray:
        """(R,) relative speed factors from active ``slow_rank`` specs."""
        speed = np.ones(num_ranks)
        for s in self._active("slow_rank"):
            if s.rank is None:
                speed[:] = np.minimum(speed, s.severity)
            else:
                speed[s.rank] = min(speed[s.rank], s.severity)
        return speed

    def check_solve(self, layer: int | None = None) -> None:
        """Raise at the plan-solve point if a solve fault is active."""
        if self._active("solve_timeout", layer):
            self.fired["solve_timeout"] += 1
            raise SolveTimeout(
                f"injected solve timeout (step {self.step}, layer {layer})")
        if self._active("solve_fail", layer):
            self.fired["solve_fail"] += 1
            raise PlannerFault(
                f"injected solve failure (step {self.step}, layer {layer})")

    def check_transfer(self, layer: int | None = None) -> None:
        """Raise a transient :class:`TransferFault` for flaky windows.

        Each active ``transfer_flaky`` spec fails the first ``count``
        attempts of the current step, then lets the transfer through --
        the shape a bounded-retry path must survive.
        """
        for i, s in enumerate(self.specs):
            if s.kind != "transfer_flaky" or not s.active(self.step, layer):
                continue
            attempts = self._flaky_attempts.get(i, 0)
            if attempts < s.count:
                self._flaky_attempts[i] = attempts + 1
                self.fired["transfer_flaky"] += 1
                raise TransferFault(
                    f"injected flaky transfer (step {self.step}, layer "
                    f"{layer}, attempt {attempts + 1}/{s.count})",
                    transient=True)

    def corrupt_payload(self, xs, layer: int | None = None):
        """NaN-corrupt a ``severity`` fraction of payload rows.

        ``xs`` is a (..., N, D) activation tensor; rows are drawn
        deterministically from the per-(step, layer) stream.  Integer
        buffers (e.g. an int8 wire) pass through unchanged -- they cannot
        encode NaN.
        """
        return self._corrupt(xs, "nan_payload", layer)

    def corrupt_replicas(self, weights, layer: int | None = None):
        """NaN-corrupt streamed replica weights (``transfer_corrupt``)."""
        return self._corrupt(weights, "transfer_corrupt", layer)

    def _corrupt(self, x, kind: str, layer: int | None):
        specs = self._active(kind, layer)
        if not specs:
            return x
        import torch

        if not torch.is_floating_point(x):
            return x
        frac = max(s.severity for s in specs)
        n = int(np.prod(x.shape[:-1]))
        k = int(np.ceil(frac * n))
        if k == 0:
            return x
        rows = self._rng(kind, layer).choice(n, size=k, replace=False)
        mask = np.zeros(n, dtype=bool)
        mask[rows] = True
        mask = torch.from_numpy(mask.reshape(x.shape[:-1])).to(x.device)
        self.fired[kind] += k
        return torch.where(mask[..., None], torch.full((), float("nan"),
                                                       dtype=x.dtype,
                                                       device=x.device), x)

    def __repr__(self) -> str:
        live = {k: v for k, v in self.fired.items() if v}
        return (f"FaultInjector(step={self.step}, specs={len(self.specs)}, "
                f"fired={live})")
