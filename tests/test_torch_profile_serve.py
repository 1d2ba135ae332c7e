"""The profiler's int8 codec ranges (``launch/profile_serve.py``).

``int8_codec_ms`` is the device time of the kernels launched inside the
``int8_codec`` ranges that ``_codec_ranges`` wraps around the codec's
functions.  On reduced GLM-4.5-Air under ``wire_dtype = ffn_dtype =
"int8"``, on the CPU: every call of a codec function in a prefill chunk and
a decode step runs inside a range, the ranged run computes the same logits
with the same operators as the plain run, and the bindings are restored
afterwards.
"""

import collections
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.reduce import reduced
from repro_torch.core.balancer import BalancerConfig
from repro_torch.launch import profile_serve
from repro_torch.models.model import init_lm
from repro_torch.models.transformer import ParallelCtx, RuntimeConfig
from repro_torch.serving.adapter import make_engine_fns

CHUNK = 32


@pytest.fixture(scope="module")
def q8_steps():
    """A prefill chunk and a decode step of reduced GLM-4.5-Air with the
    int8 wire and the w8a8 FFN, each warmed up once."""
    cfg = reduced(get_config("glm45-106b-a12b"))
    rcfg = RuntimeConfig(balancer=BalancerConfig(mode="ultraep", n_slot=2),
                         cf_pair=4.0, cf_slot=4.0, wire_dtype="int8",
                         ffn_dtype="int8")
    params = init_lm(cfg, rcfg, ParallelCtx(), torch.Generator().manual_seed(0),
                     device="cpu")
    prefill, decode, new_cache, stack, _ = make_engine_fns(
        params, cfg, rcfg, ParallelCtx(), max_seq=2 * CHUNK + 8)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(
        1, CHUNK)).astype(np.int32))
    _, cache = prefill(toks, new_cache(1), 0, CHUNK)
    caches = stack([cache] * 2)
    step_toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(
        2, 1)).astype(np.int32))
    steps = {"prefill": lambda: prefill(toks, cache, CHUNK, CHUNK)[0],
             "decode": lambda: decode(step_toks, caches)[0]}
    for step in steps.values():
        step()
    return steps


@pytest.mark.parametrize("step", ["prefill", "decode"])
def test_every_codec_call_falls_inside_a_range(q8_steps, step):
    codec_codes = {f.__code__ for f in
                   profile_serve._codec_functions().values()}
    ranged_code = profile_serve._ranged(len).__code__
    calls = collections.Counter()

    def tracer(frame, event, arg):
        if event != "call" or frame.f_code not in codec_codes:
            return
        f = frame.f_back
        while f is not None and f.f_code is not ranged_code:
            f = f.f_back
        calls["inside" if f is not None else frame.f_code.co_name] += 1

    with profile_serve._codec_ranges():
        sys.setprofile(tracer)
        try:
            q8_steps[step]()
        finally:
            sys.setprofile(None)
    assert calls["inside"] > 0
    assert set(calls) == {"inside"}, calls


@pytest.mark.parametrize("step", ["prefill", "decode"])
def test_ranged_run_matches_the_plain_run(q8_steps, step):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import quantize
    from repro_torch.moe import expert, stages

    bound = {(m, a): getattr(m, a) for m, a in (
        (quantize, "quantize_rows"), (expert, "quantize_rows"),
        (stages, "encode_wire"), (stages, "split_wire_int8"))}

    def run(ranged: bool):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            if ranged:
                with profile_serve._codec_ranges():
                    assert all(getattr(m, a) is not fn
                               for (m, a), fn in bound.items())
                    out = q8_steps[step]()
            else:
                out = q8_steps[step]()
        ops = collections.Counter(e.name for e in prof.events()
                                  if e.name != "int8_codec")
        ranges = sum(e.name == "int8_codec" for e in prof.events())
        return out, ops, ranges

    out, ops, ranges = run(False)
    out_r, ops_r, ranges_r = run(True)
    assert ranges == 0 and ranges_r > 0
    assert torch.equal(out, out_r)
    assert ops == ops_r
    assert all(getattr(m, a) is fn for (m, a), fn in bound.items())
