"""The port's serving engine under injected faults, against the JAX engine.

Mirrors the reference's serving-engine fault cases (``tests/test_fault.py``):
a transient prefill fault is retried, a permanently failing prefill and a
failing decode group are retired after ``max_retries`` retries, and
non-finite logits are screened.  Each case drives the JAX
``repro.serving.engine.ServingEngine`` and the port's
``repro_torch.serving.engine.ServingEngine`` with the same stub prefill and
decode functions (each engine with its own, on its own arrays) and the same
requests; the fault counters, the ``failed`` flags and the outputs must be
equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine

V = 11


def _jax_engine(prefill_fails, decode_fails, nan_logits, max_retries):
    calls = {"prefill": 0, "decode": 0}

    def prefill(toks, cache, pos, length):
        calls["prefill"] += 1
        if calls["prefill"] <= prefill_fails:
            raise RuntimeError("injected prefill fault")
        logits = jnp.full((1, toks.shape[1], V),
                          jnp.nan if nan_logits else 0.0)
        if not nan_logits:
            logits = logits.at[..., 3].set(1.0)
        return logits, cache

    def decode(toks, caches):
        calls["decode"] += 1
        if calls["decode"] <= decode_fails:
            raise RuntimeError("injected decode fault")
        return jnp.zeros((toks.shape[0], 1, V)).at[..., 5].set(1.0), caches

    return JServingEngine(
        JEngineConfig(chunk_size=8, decode_batch=2, max_retries=max_retries),
        prefill_fn=prefill, decode_fn=decode,
        new_cache_fn=lambda b: {"n": jnp.zeros((b, 1))},
        stack_caches=lambda cs: {"n": jnp.concatenate([c["n"] for c in cs])})


def _torch_engine(prefill_fails, decode_fails, nan_logits, max_retries):
    calls = {"prefill": 0, "decode": 0}

    def prefill(toks, cache, pos, length):
        calls["prefill"] += 1
        if calls["prefill"] <= prefill_fails:
            raise RuntimeError("injected prefill fault")
        logits = torch.full((1, toks.shape[1], V),
                            float("nan") if nan_logits else 0.0)
        if not nan_logits:
            logits[..., 3] = 1.0
        return logits, cache

    def decode(toks, caches):
        calls["decode"] += 1
        if calls["decode"] <= decode_fails:
            raise RuntimeError("injected decode fault")
        logits = torch.zeros((toks.shape[0], 1, V))
        logits[..., 5] = 1.0
        return logits, caches

    return ServingEngine(
        EngineConfig(chunk_size=8, decode_batch=2, max_retries=max_retries),
        prefill_fn=prefill, decode_fn=decode,
        new_cache_fn=lambda b: torch.zeros((b, 1)),
        stack_caches=lambda cs: torch.cat(cs),
        unstack_caches=lambda c, n: list(c.split(1)))


def _run_both(n, **faults):
    out = []
    for make, req in ((_jax_engine, JRequest), (_torch_engine, Request)):
        eng = make(**faults)
        for i in range(n):
            eng.submit(req(rid=i, prompt=np.arange(10, dtype=np.int32),
                           max_new_tokens=3))
        done = eng.run()                     # terminates, never raises
        out.append((eng, sorted(done, key=lambda r: r.rid)))
    (jeng, jdone), (teng, tdone) = out
    assert teng.fault_counters == jeng.fault_counters
    assert [r.failed for r in tdone] == [r.failed for r in jdone]
    assert [r.output for r in tdone] == [r.output for r in jdone]
    assert teng.ttft().size == jeng.ttft().size
    assert teng.tpot().size == jeng.tpot().size
    return teng, tdone


FAULTS = dict(prefill_fails=0, decode_fails=0, nan_logits=False,
              max_retries=1)


@pytest.mark.parametrize("case", ["transient_prefill", "failing_prefill",
                                  "failing_decode", "nonfinite_logits"])
def test_engine_faults_match_jax(case):
    if case == "transient_prefill":
        eng, done = _run_both(2, **dict(FAULTS, prefill_fails=1))
        assert len(done) == 2 and not any(r.failed for r in done)
        assert eng.fault_counters["prefill_retries"] == 1
        assert eng.fault_counters["failed_requests"] == 0
    elif case == "failing_prefill":
        eng, done = _run_both(2, **dict(FAULTS, prefill_fails=10 ** 6))
        assert len(done) == 2 and all(r.failed for r in done)
        assert eng.fault_counters["failed_requests"] == 2
        assert eng.ttft().size == 0 and eng.tpot().size == 0
        assert isinstance(eng.last_error, RuntimeError)
    elif case == "failing_decode":
        eng, done = _run_both(2, **dict(FAULTS, decode_fails=10 ** 6))
        assert len(done) == 2 and all(r.failed for r in done)
        # max_retries=1: one retry before the group is retired
        assert eng.fault_counters["decode_retries"] == 1
        assert eng.fault_counters["failed_requests"] == 2
    else:
        eng, done = _run_both(1, **dict(FAULTS, nan_logits=True))
        assert not done[0].failed
        assert done[0].output[0] == 0        # all-NaN row degrades to token 0
        assert eng.fault_counters["nonfinite_logits"] >= 1
