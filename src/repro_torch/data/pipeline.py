"""Deterministic synthetic LM stream with non-stationary domain mixture.

The port's own copy of ``repro.data.pipeline`` (numpy only, no change):
the same (seed, step) gives the same batch, bit for bit, in both packages.

The paper's S3 load analysis shows expert popularity shifting across data
domains and batches; this pipeline reproduces that forcing function without
external data: each *domain* is a Zipf-distributed token source over a
distinct vocabulary region, and the domain mixture drifts smoothly with the
step index (plus occasional hard domain switches).  Routing through a
learned gate on such a stream produces exactly the skewed, non-stationary
per-expert loads of Fig. 4/5 -- see benchmarks/bench_planner.py --trace.

Determinism: every batch is a pure function of (seed, step), so restart
replay after a failure is bitwise identical (the reference's train/fault.py
relies on it).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["DataConfig", "SyntheticLMStream"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    num_domains: int = 4
    zipf_a: float = 1.3
    drift_period: int = 64          # steps per smooth mixture cycle
    switch_period: int = 50         # steps between hard domain switches
    seed: int = 0


class SyntheticLMStream:
    """Iterable over {tokens, targets} int32 arrays."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # Fixed per-domain rank->token permutation so each domain has its
        # own popular-token set (disjoint hot regions).
        self._perms = [rng.permutation(cfg.vocab_size)
                       for _ in range(cfg.num_domains)]
        # Zipf pmf truncated to the vocab.
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        pmf = ranks ** (-cfg.zipf_a)
        self._pmf = pmf / pmf.sum()

    def mixture(self, step: int) -> np.ndarray:
        """Domain mixture weights at a step (smooth drift + hard switches)."""
        cfg = self.cfg
        t = 2 * np.pi * (step % cfg.drift_period) / cfg.drift_period
        base = 1.0 + np.cos(t + np.arange(cfg.num_domains)
                            * 2 * np.pi / cfg.num_domains)
        # Hard switch: one domain dominates for a window.
        dom = (step // cfg.switch_period) % cfg.num_domains
        base[dom] += 2.0 * ((step // cfg.switch_period) % 2)
        return base / base.sum()

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        mix = self.mixture(step)
        # Assign each sequence to a domain.
        doms = rng.choice(cfg.num_domains, size=cfg.global_batch, p=mix)
        toks = np.empty((cfg.global_batch, cfg.seq_len + 1), np.int32)
        for d in range(cfg.num_domains):
            rows = np.where(doms == d)[0]
            if len(rows) == 0:
                continue
            draws = rng.choice(cfg.vocab_size, size=(len(rows),
                                                     cfg.seq_len + 1),
                               p=self._pmf)
            toks[rows] = self._perms[d][draws]
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1
