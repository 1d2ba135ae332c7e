"""Per-rank health state: throughput weights + quarantine for the planner.

Mirrors ``repro.core.health`` (host-side numpy).

UltraEP's planner assumes a *stationary fabric*: every rank equally fast,
every transfer landing.  Production balancers face degraded fabrics -- a
straggling GPU, a flaky NIC, a rank drained for maintenance -- and a
balancer that keeps assigning a full quota to a half-speed rank turns one
slow device into a whole-step slowdown.  :class:`RankHealth` closes the
loop (DESIGN.md S13): observed per-rank step/stage times are folded into an
EWMA throughput weight per rank, persistent z-score outliers are
quarantined, and :meth:`planner_weights` exports the (R,) capacity vector
consumed by :func:`repro_torch.core.planner.solve_replication` -- a 0.5x-speed
rank gets ~0.5x quota, a quarantined rank drains to zero and its home
experts replicate away.

The module is host-side numpy (like :mod:`repro_torch.core.comm_plan`):
health evolves between steps on the host; only the resulting weight vector
enters the solve, as a tensor argument on the solve's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["HealthConfig", "RankHealth"]


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Knobs of the EWMA health estimator."""

    ewma_decay: float = 0.8        # per-observation decay of the time EWMA
    quarantine_zscore: float = 3.0  # across-rank z-score flagging a straggler
    quarantine_after: int = 3      # consecutive flagged obs -> quarantine
    recover_after: int = 10        # consecutive clean obs -> release
    min_weight: float = 0.05       # weight floor for non-quarantined ranks

    def __post_init__(self):
        if not 0.0 < self.ewma_decay < 1.0:
            raise ValueError(f"ewma_decay={self.ewma_decay} must be in (0,1)")
        if not 0.0 < self.min_weight <= 1.0:
            raise ValueError(
                f"min_weight={self.min_weight} must be in (0,1]")


class RankHealth:
    """EWMA per-rank throughput weight + quarantine mask.

    ``weight[r]`` is the rank's relative throughput in ``(0, 1]`` (fastest
    observed rank == 1.0); ``quarantined[r]`` marks ranks whose observed
    times are persistent across-rank z-score outliers.  Feed observations
    with :meth:`observe`; read the planner-facing capacity vector with
    :meth:`planner_weights` (quarantined ranks -> 0.0).
    """

    def __init__(self, num_ranks: int, cfg: HealthConfig = HealthConfig()):
        if num_ranks < 1:
            raise ValueError(f"num_ranks={num_ranks} must be >= 1")
        self.cfg = cfg
        self.num_ranks = num_ranks
        self.weight = np.ones(num_ranks)
        self.quarantined = np.zeros(num_ranks, dtype=bool)
        self._ewma_time = np.zeros(num_ranks)
        self._seen = 0
        self._flag_streak = np.zeros(num_ranks, dtype=np.int64)
        self._clean_streak = np.zeros(num_ranks, dtype=np.int64)

    # ------------- updates -------------

    def observe(self, rank_times) -> np.ndarray:
        """Fold one (R,) vector of per-rank durations into the EWMA state.

        Non-positive or non-finite entries are ignored for that rank (a
        monotonic-clock duration is always > 0; a NaN means the measurement
        itself was lost, which must not poison the estimator).  Returns the
        (R,) bool mask of ranks flagged as stragglers this observation.
        """
        t = np.asarray(rank_times, dtype=np.float64).reshape(-1)
        if t.shape[0] != self.num_ranks:
            raise ValueError(
                f"rank_times has {t.shape[0]} entries, expected "
                f"{self.num_ranks}")
        ok = np.isfinite(t) & (t > 0)
        if not ok.any():
            return np.zeros(self.num_ranks, dtype=bool)
        d = self.cfg.ewma_decay
        if self._seen == 0:
            self._ewma_time[ok] = t[ok]
        else:
            self._ewma_time[ok] = (d * self._ewma_time[ok]
                                   + (1 - d) * t[ok])
            # Ranks never observed yet adopt the current value outright.
            fresh = ok & (self._ewma_time <= 0)
            self._ewma_time[fresh] = t[fresh]
        self._seen += 1

        # Relative throughput: fastest EWMA rank defines weight 1.0.
        est = self._ewma_time
        pos = est > 0
        fastest = est[pos].min() if pos.any() else 1.0
        self.weight = np.where(pos, fastest / np.maximum(est, 1e-12), 1.0)
        self.weight = np.clip(self.weight, self.cfg.min_weight, 1.0)

        # Across-rank z-score on this observation flags stragglers.
        # Leave-one-out: a single extreme straggler inflates the pooled std
        # enough to hide itself (the pooled z is bounded by sqrt(R-1), below
        # the default threshold for small R); scoring each rank against its
        # *peers* has no such ceiling.  The std floor is relative to the
        # peer mean so identical peers don't turn measurement noise into a
        # flag.
        flagged = np.zeros(self.num_ranks, dtype=bool)
        if ok.sum() >= 3:
            idx = np.where(ok)[0]
            for r in idx:
                peers = t[idx[idx != r]]
                mu = peers.mean()
                sd = max(peers.std(), 0.01 * abs(mu), 1e-12)
                flagged[r] = (t[r] - mu) / sd > self.cfg.quarantine_zscore
        self._flag_streak = np.where(flagged, self._flag_streak + 1, 0)
        self._clean_streak = np.where(ok & ~flagged,
                                      self._clean_streak + 1,
                                      np.where(flagged, 0,
                                               self._clean_streak))
        self.quarantined |= self._flag_streak >= self.cfg.quarantine_after
        recovered = self.quarantined & (
            self._clean_streak >= self.cfg.recover_after)
        self.quarantined &= ~recovered
        return flagged

    def quarantine(self, rank: int) -> None:
        """Force a rank into quarantine (operator action / supervisor flag)."""
        self.quarantined[rank] = True
        self._clean_streak[rank] = 0

    def release(self, rank: int) -> None:
        """Lift a quarantine and reset the rank's streak counters."""
        self.quarantined[rank] = False
        self._flag_streak[rank] = 0

    # ------------- planner-facing view -------------

    def planner_weights(self) -> np.ndarray:
        """(R,) float64 capacity weights: quarantined -> 0.0, else weight.

        All-quarantined states degenerate to uniform weights -- a planner
        with zero total capacity has no valid objective, and draining
        *every* rank is indistinguishable from draining none.
        """
        w = np.where(self.quarantined, 0.0, self.weight)
        if w.max() <= 0:
            return np.ones(self.num_ranks)
        return w

    @property
    def num_quarantined(self) -> int:
        return int(self.quarantined.sum())

    def __repr__(self) -> str:
        return (f"RankHealth(R={self.num_ranks}, "
                f"weight={np.round(self.weight, 3).tolist()}, "
                f"quarantined={np.where(self.quarantined)[0].tolist()})")
