"""Fault-tolerant training supervisor: checkpoint/restart, stragglers,
elastic restart.

Mirrors ``repro.train.fault``.  The supervisor owns the step loop.  On a
runtime failure (a ``RuntimeError``, the counterpart of JAX's
``JaxRuntimeError``; CUDA and ``torch.distributed`` errors are
RuntimeErrors) it restores the latest checkpoint and replays the
deterministic data stream from the recovered step (the same batches, bit
for bit), until ``max_restarts``.  A ``rebuild_fn`` may hand back a new
step function after a failure (elastic restart: the checkpoint holds
global shapes, so it restores onto any group size).  Straggler detection
tracks an EWMA of the step time on ``time.monotonic()`` and flags z-score
outliers; the step times feed a per-rank
:class:`repro_torch.core.health.RankHealth`, whose weights the planner
takes (``solve_plan(health_weight=)``).

On a mesh (``pctx`` with more than one rank) every rank runs its own
supervisor over the same step function, checkpoints hold the global state
(``train.loop.state_to_global``, rank 0 writes) and every rank restores
its share.  A fault is recovered only when every rank meets it at the
same step: a rank that raises alone cannot be rescued over gloo, because
the others wait in their next collective until the group's timeout.
There is no watchdog for that case, as there is none in the reference.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.core.health import HealthConfig, RankHealth
from repro_torch.models.transformer import ParallelCtx
from repro_torch.train.loop import (TrainState, global_shapes,
                                    state_from_global, state_to_global)

__all__ = ["SupervisorConfig", "Supervisor"]


@dataclasses.dataclass
class SupervisorConfig:
    checkpoint_dir: str | None
    checkpoint_every: int = 50      # <= 0: no checkpoints (a fault raises)
    max_restarts: int = 3
    straggler_zscore: float = 3.0
    ewma_decay: float = 0.9
    num_ranks: int = 1              # EP ranks tracked by the health model


class Supervisor:
    """Runs ``state = step_fn(state, batch)`` with failure recovery.

    ``state`` is a :class:`repro_torch.train.loop.TrainState` (saved at
    global shapes on any mesh) or a flat mapping of names to tensors
    (saved as it is, restored as CPU tensors)."""

    def __init__(self, cfg: SupervisorConfig, step_fn: Callable,
                 batch_fn: Callable[[int], Any], *,
                 pctx: ParallelCtx = ParallelCtx(),
                 rebuild_fn: Callable[[], Callable] | None = None):
        self.cfg = cfg
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.rebuild_fn = rebuild_fn
        self.pctx = pctx
        self.ckpt = (Checkpointer(cfg.checkpoint_dir, group=pctx.world_group)
                     if cfg.checkpoint_every > 0 else None)
        self.restarts = 0
        self.step_times: list[float] = []
        self._ewma = None
        self._ewvar = 0.0
        self.straggler_flags: list[int] = []
        self.health = RankHealth(cfg.num_ranks, HealthConfig(
            ewma_decay=cfg.ewma_decay,
            quarantine_zscore=cfg.straggler_zscore))

    def rank_health(self) -> RankHealth:
        """The live per-rank health model (planner-consumable weights)."""
        return self.health

    def _track_time(self, step: int, dt: float,
                    rank_times: np.ndarray | None = None):
        self.step_times.append(dt)
        # Per-rank times (metrics["rank_step_times"] when the step reports
        # them, else the global dt broadcast) feed the health model.
        if rank_times is None:
            rank_times = np.full(self.cfg.num_ranks, dt)
        self.health.observe(np.asarray(rank_times, dtype=np.float64))
        if self._ewma is None:
            self._ewma = dt
            return
        d = self.cfg.ewma_decay
        dev = dt - self._ewma
        self._ewma = d * self._ewma + (1 - d) * dt
        self._ewvar = d * self._ewvar + (1 - d) * dev * dev
        sd = max(np.sqrt(self._ewvar), 1e-9)
        if dev / sd > self.cfg.straggler_zscore and len(self.step_times) > 8:
            self.straggler_flags.append(step)

    def _save(self, step: int, state, *, blocking: bool = False):
        tree = (state_to_global(state, self.pctx)
                if isinstance(state, TrainState) else state)
        self.ckpt.save(step, tree, blocking=blocking)

    def _restore(self, state, step: int):
        if isinstance(state, TrainState):
            tree, step = self.ckpt.restore(global_shapes(state, self.pctx),
                                           step)
            return state_from_global(state, tree, self.pctx), step
        tree, step = self.ckpt.restore(
            {k: list(np.shape(v)) for k, v in state.items()}, step)
        return {k: torch.as_tensor(v) for k, v in tree.items()}, step

    def run(self, state, start_step: int, num_steps: int,
            on_metrics: Callable | None = None):
        """Run to ``start_step + num_steps`` with recovery.  Returns
        ``(state, step)``."""
        every = self.cfg.checkpoint_every
        step = start_step
        end = start_step + num_steps
        while step < end:
            try:
                batch = self.batch_fn(step)
                # Monotonic clock: step durations must survive wall-clock
                # adjustments (NTP slew would poison the straggler z-score).
                t0 = time.monotonic()
                state, metrics = self.step_fn(state, batch)
                float(metrics["loss"])              # waits for the device
                rank_times = metrics.get("rank_step_times")
                if rank_times is not None:
                    rank_times = np.asarray(rank_times)
                self._track_time(step, time.monotonic() - t0,
                                 rank_times=rank_times)
                step += 1
                if on_metrics is not None:
                    on_metrics(step, metrics)
                if every > 0 and step % every == 0:
                    self._save(step, state)
            except RuntimeError as e:
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise RuntimeError(
                        f"supervisor: giving up after {self.restarts} restarts"
                    ) from e
                latest = None
                if every > 0:
                    self.ckpt.wait()        # a pending write lands first
                    latest = self.ckpt.latest_step()
                if latest is None:
                    raise
                if self.rebuild_fn is not None:
                    # Elastic restart: the caller may hand back a step_fn
                    # bound to a rebuilt (possibly smaller) group.
                    self.step_fn = self.rebuild_fn()
                state, step = self._restore(state, latest)
        if every > 0:
            self._save(step, state, blocking=True)
        return state, step
