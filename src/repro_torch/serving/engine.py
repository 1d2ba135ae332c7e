"""Process-level serving engine: chunked prefill + batched decode.

Mirrors ``repro.serving.engine`` on torch tensors: requests queue up,
prompts are prefilled in fixed-size chunks (paper: 4K) one request at a
time, then sequences decode in a fixed-slot batch.  A faulting model call
(``RuntimeError``) is retried up to ``max_retries`` times, after which the
request (prefill) or decode group is retired as failed instead of stalling
the queue; the last such error is kept in ``last_error``.  A virtual clock
advances by ``clock_fn()`` after each call, so TTFT/TPOT work both for
measured execution and for analytic replay.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable

import numpy as np
import torch

from repro_torch.moe.stages import chunk_bounds

__all__ = ["EngineConfig", "Request", "ServingEngine"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (len,) int32
    max_new_tokens: int
    arrival: float = 0.0
    first_token_at: float | None = None
    done_at: float | None = None
    output: list | None = None
    failed: bool = False


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    chunk_size: int = 4096
    decode_batch: int = 8
    max_seq: int = 8192
    max_retries: int = 1


class ServingEngine:
    """Drives (prefill_fn, decode_fn) over a request queue.

    prefill_fn(tokens (1, chunk) int32 CPU tensor, cache, start, valid_len)
        -> (logits, cache)
    decode_fn(tokens (B, 1) int32 CPU tensor, caches) -> (logits, caches)
    new_cache_fn(batch) -> cache; stack_caches(list) -> batched caches;
    unstack_caches(caches, n) -> list of per-request caches.
    """

    def __init__(self, cfg: EngineConfig, *, prefill_fn: Callable,
                 decode_fn: Callable, new_cache_fn: Callable,
                 stack_caches: Callable, unstack_caches: Callable,
                 clock_fn: Callable | None = None):
        self.cfg = cfg
        self.prefill_fn = prefill_fn
        self.decode_fn = decode_fn
        self.new_cache_fn = new_cache_fn
        self.stack_caches = stack_caches
        self.unstack_caches = unstack_caches
        self.clock_fn = clock_fn
        self.now = 0.0
        self.waiting: deque[Request] = deque()
        self.decoding: list[tuple[Request, object]] = []
        self.finished: list[Request] = []
        self.last_error: Exception | None = None
        self.fault_counters = {
            "prefill_retries": 0,
            "decode_retries": 0,
            "failed_requests": 0,
            "nonfinite_logits": 0,
        }

    def submit(self, req: Request):
        self.waiting.append(req)

    def _advance(self, dt: float):
        self.now += dt

    def _fail(self, req: Request):
        req.failed = True
        req.done_at = self.now
        self.fault_counters["failed_requests"] += 1
        self.finished.append(req)

    def _argmax_token(self, row: np.ndarray) -> int:
        """Greedy token with non-finite logits screened (counted)."""
        row = np.asarray(row, dtype=np.float64)
        finite = np.isfinite(row)
        if not finite.all():
            self.fault_counters["nonfinite_logits"] += 1
            if not finite.any():
                return 0
            row = np.where(finite, row, -np.inf)
        return int(np.argmax(row))

    def _prefill(self, req: Request):
        cache = self.new_cache_fn(1)
        last_logits = None
        for pos, length in chunk_bounds(len(req.prompt),
                                        chunk_size=self.cfg.chunk_size):
            chunk = req.prompt[pos: pos + length]
            toks = np.pad(chunk, (0, self.cfg.chunk_size - length))[None, :]
            last_logits, cache = self.prefill_fn(
                torch.from_numpy(toks.astype(np.int32)), cache, pos, length)
            self._advance(self.clock_fn() if self.clock_fn else 0.0)
        return last_logits, cache

    def run(self, until_empty: bool = True):
        """Alternate prefill and decode until the queues drain, or, with
        ``until_empty=False``, for one round of each (mirrors
        ``repro.serving.engine.ServingEngine.run``)."""
        while self.waiting or self.decoding:
            if self.waiting:
                req = self.waiting.popleft()
                if self.now < req.arrival:
                    self.now = req.arrival
                last_logits = cache = None
                for attempt in range(self.cfg.max_retries + 1):
                    try:
                        last_logits, cache = self._prefill(req)
                        break
                    except RuntimeError as e:
                        self.last_error = e
                        if attempt == self.cfg.max_retries:
                            self._fail(req)
                        else:
                            self.fault_counters["prefill_retries"] += 1
                if last_logits is not None:
                    req.first_token_at = self.now
                    # Host-side scheduling: reading the logits back is the point.
                    row = last_logits[0, -1].float().cpu().numpy()
                    req.output = [self._argmax_token(row)]
                    self.decoding.append((req, cache))

            if self.decoding and (len(self.decoding) >= self.cfg.decode_batch
                                  or not self.waiting):
                group = self.decoding[: self.cfg.decode_batch]
                toks = np.array([[r.output[-1]] for r, _ in group], np.int32)
                caches = self.stack_caches([c for _, c in group])
                logits = None
                for attempt in range(self.cfg.max_retries + 1):
                    try:
                        logits, caches = self.decode_fn(torch.from_numpy(toks),
                                                        caches)
                        break
                    except RuntimeError as e:
                        self.last_error = e
                        if attempt == self.cfg.max_retries:
                            for r, _ in group:
                                self._fail(r)
                            self.decoding = self.decoding[
                                self.cfg.decode_batch:]
                        else:
                            self.fault_counters["decode_retries"] += 1
                if logits is None:
                    continue
                self._advance(self.clock_fn() if self.clock_fn else 0.0)
                logits_np = logits[:, -1].float().cpu().numpy()
                still = []
                for i, (r, _) in enumerate(group):
                    r.output.append(self._argmax_token(logits_np[i]))
                    if len(r.output) >= r.max_new_tokens:
                        r.done_at = self.now
                        self.finished.append(r)
                    else:
                        still.append(i)
                new_caches = self.unstack_caches(caches, len(group))
                self.decoding = (
                    [(group[i][0], new_caches[i]) for i in still]
                    + self.decoding[self.cfg.decode_batch:])
            if not until_empty:
                break
        return self.finished

    def ttft(self) -> np.ndarray:
        return np.array([r.first_token_at - r.arrival for r in self.finished
                         if not r.failed and r.first_token_at is not None])

    def tpot(self) -> np.ndarray:
        out = []
        for r in self.finished:
            if r.failed or r.first_token_at is None:
                continue
            n = max(len(r.output) - 1, 1)
            out.append((r.done_at - r.first_token_at) / n)
        return np.array(out)
