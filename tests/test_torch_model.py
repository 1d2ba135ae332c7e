"""Port LM vs the JAX LM on reduced GLM-4.5-Air, reduced Jamba-v0.1
(8 layers: mamba+dense, mamba+moe, attn+dense), reduced Qwen3-235B-A22B
(per-head q/k RMSNorm) and reduced DeepSeek-V3 (MLA on the latent cache,
1 dense + 3 MoE layers, a sigmoid router with routed scaling 2.5 and no
selection bias when serving) with converted weights.

The JAX parameters (``repro.models.model.init_lm``, scan_layers=True, so
segments are stacked on a layer axis, and a 16-layer Jamba's repeating
period becomes one "cycle" segment) go through ``repro_torch.convert``.
Chunked prefill and batched decode logits must agree within 1e-4 (fp32),
and one served trace must give identical greedy tokens from the JAX engine
functions (``repro.serving.adapter``, as ``repro.launch.serve`` builds
them) and from the port's.  The prefill chunk (64) is a multiple of the
reduced SSD chunk (16).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.reduce import reduced as j_reduced
from repro.core.balancer import BalancerConfig as JBalancerConfig
from repro.models.model import init_lm as j_init_lm
from repro.models.transformer import ParallelCtx as JParallelCtx
from repro.models.transformer import RuntimeConfig as JRuntimeConfig
from repro.serving.adapter import make_engine_fns as j_make_engine_fns
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.reduce import reduced
from repro_torch.core.balancer import BalancerConfig
from repro_torch.models.transformer import ParallelCtx, RuntimeConfig
from repro_torch.serving.adapter import make_engine_fns
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine

GLM, JAMBA = "glm45-106b-a12b", "jamba-v0.1-52b"
QWEN3, DEEPSEEK = "qwen3-235b-a22b", "deepseek-v3-671b"
CHUNK = 64
MAX_SEQ = 272          # = prompt max 200 + max_new 8 + chunk 64
TOL = 1e-4


def _with_dense_prefix(cfg):
    return dataclasses.replace(
        cfg, d_ff=128, moe=dataclasses.replace(cfg.moe, first_dense_layers=1))


def _build(arch: str, dense_prefix: bool = False, layers: int | None = None,
           **runtime):
    jcfg = j_reduced(j_get_config(arch), layers=layers)
    tcfg = reduced(get_config(arch), layers=layers)
    if dense_prefix:
        jcfg, tcfg = _with_dense_prefix(jcfg), _with_dense_prefix(tcfg)
    jrcfg = JRuntimeConfig(balancer=JBalancerConfig(mode="ultraep", n_slot=2),
                           cf_pair=4.0, cf_slot=4.0, scan_layers=True,
                           remat=False, **runtime)
    trcfg = RuntimeConfig(balancer=BalancerConfig(mode="ultraep", n_slot=2),
                          cf_pair=4.0, cf_slot=4.0, **runtime)
    jparams = j_init_lm(jax.random.PRNGKey(0), jcfg, jrcfg,
                        JParallelCtx(mesh=None))
    tparams = convert.lm_params(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    jfns = j_make_engine_fns(jparams, jcfg, jrcfg, JParallelCtx(mesh=None),
                             max_seq=MAX_SEQ)
    tfns = make_engine_fns(tparams, tcfg, trcfg, ParallelCtx(),
                           max_seq=MAX_SEQ)
    return jcfg, jfns, tfns, jparams


def _close(j, t):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch,dense_prefix", [(GLM, False), (GLM, True),
                                               (JAMBA, False), (QWEN3, False),
                                               (DEEPSEEK, False)])
def test_prefill_and_decode_logits_match_jax(arch, dense_prefix):
    cfg, (jpre, jdec, jnew, jstack, _), (tpre, tdec, tnew, tstack, _), _ = \
        _build(arch, dense_prefix)
    rng = np.random.default_rng(0)
    j_caches, t_caches = [], []
    for length in (100, 40):              # two chunks, then one ragged chunk
        prompt = rng.integers(0, cfg.vocab_size, size=length).astype(np.int32)
        jc, tc = jnew(1), tnew(1)
        for pos in range(0, length, CHUNK):
            n = min(CHUNK, length - pos)
            toks = np.pad(prompt[pos:pos + n], (0, CHUNK - n))[None, :]
            jl, jc = jpre(jax.numpy.asarray(toks), jc, pos, n)
            tl, tc = tpre(torch.from_numpy(toks), tc, pos, n)
            _close(jl, tl)
        j_caches.append(jc)
        t_caches.append(tc)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 1)).astype(np.int32)
    jl, _ = jdec(jax.numpy.asarray(toks), jstack(j_caches))
    tl, _ = tdec(torch.from_numpy(toks), tstack(t_caches))
    _close(jl, tl)


def test_q8_runtime_prefill_and_decode_match_jax():
    """GLM-4.5-Air under ``wire_dtype = ffn_dtype = "int8"``: the int8 EP
    wire feeds the w8a8 FFN at prefill, the FFN quantizes its own rows at
    decode.  Logits within 1e-4 * max|ref| and the same greedy tokens.

    The frameworks' silu differ by an ulp on part of the gate's outputs,
    which can carry an activation across a rounding boundary of its int8
    code (one code step is max|act row| / 127).  So at most 2 tokens of a
    check may exceed 1e-4, none 2e-3, and every greedy token must agree."""
    cfg, (jpre, jdec, jnew, jstack, _), (tpre, tdec, tnew, tstack, _), _ = \
        _build(GLM, wire_dtype="int8", ffn_dtype="int8")
    rng = np.random.default_rng(2)
    j_caches, t_caches = [], []

    def check(jl, tl):
        jl, tl = np.asarray(jl), tl.numpy()
        err, scale = np.abs(tl - jl), np.abs(jl).max()
        assert (err > TOL * scale).any(-1).sum() <= 2
        assert err.max() <= 2e-3 * scale
        np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))

    for length in (100, 40):
        prompt = rng.integers(0, cfg.vocab_size, size=length).astype(np.int32)
        jc, tc = jnew(1), tnew(1)
        for pos in range(0, length, CHUNK):
            n = min(CHUNK, length - pos)
            toks = np.pad(prompt[pos:pos + n], (0, CHUNK - n))[None, :]
            jl, jc = jpre(jax.numpy.asarray(toks), jc, pos, n)
            tl, tc = tpre(torch.from_numpy(toks), tc, pos, n)
            check(jl[:, :n], tl[:, :n])
        j_caches.append(jc)
        t_caches.append(tc)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 1)).astype(np.int32)
    jl, _ = jdec(jax.numpy.asarray(toks), jstack(j_caches))
    tl, _ = tdec(torch.from_numpy(toks), tstack(t_caches))
    check(jl, tl)


def _requests(cls, vocab):
    rng = np.random.default_rng(0)
    t, out = 0.0, []
    for i in range(6):
        t += rng.exponential(1.0 / 4.0)
        L = int(rng.integers(32, 200))
        out.append(cls(rid=i, prompt=rng.integers(0, vocab, size=L
                                                  ).astype(np.int32),
                       max_new_tokens=8, arrival=t))
    return out


@pytest.mark.parametrize("arch", [GLM, JAMBA, QWEN3, DEEPSEEK])
def test_served_trace_gives_identical_greedy_tokens(arch):
    cfg, jfns, tfns, _ = _build(arch)
    outs = []
    for fns, ecls, ccls, rcls in ((jfns, JServingEngine, JEngineConfig,
                                   JRequest),
                                  (tfns, ServingEngine, EngineConfig, Request)):
        pre, dec, new, stack, unstack = fns
        eng = ecls(ccls(chunk_size=CHUNK, decode_batch=4, max_seq=MAX_SEQ),
                   prefill_fn=pre, decode_fn=dec, new_cache_fn=new,
                   stack_caches=stack, unstack_caches=unstack)
        for r in _requests(rcls, cfg.vocab_size):
            eng.submit(r)
        done = sorted(eng.run(), key=lambda r: r.rid)
        assert len(done) == 6 and not any(r.failed for r in done)
        assert eng.fault_counters["nonfinite_logits"] == 0
        outs.append([r.output for r in done])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_entry_point_takes_a_dtype(dtype):
    """The serve entry point on a reduced model, as a user runs it (here on
    the CPU): every request finishes with its tokens."""
    from repro_torch.launch.serve import main

    eng = main(["--arch", GLM, "--reduce", "--requests", "2", "--chunk", "64",
                "--max-new", "3", "--device", "cpu", "--dtype", dtype])
    assert len(eng.finished) == 2
    assert all(not r.failed and len(r.output) == 3 for r in eng.finished)


def test_lm_params_converts_cycle_segment():
    """16-layer Jamba: JAX stores layers 0..15 as one cycle segment of 8
    entries stacked over 2 repetitions; the converted port LM gives the same
    prefill logits (two chunks, the second ragged) and decode logits."""
    cfg, (jpre, jdec, jnew, _, _), (tpre, tdec, tnew, _, _), jparams = \
        _build(JAMBA, layers=16)
    assert len(jparams.segments) == 1 and len(jparams.segments[0]) == 8
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, size=100).astype(np.int32)
    jc, tc = jnew(1), tnew(1)
    for pos in range(0, len(prompt), CHUNK):
        n = min(CHUNK, len(prompt) - pos)
        toks = np.pad(prompt[pos:pos + n], (0, CHUNK - n))[None, :]
        jl, jc = jpre(jax.numpy.asarray(toks), jc, pos, n)
        tl, tc = tpre(torch.from_numpy(toks), tc, pos, n)
        _close(jl, tl)
    toks = prompt[-1:][None, :]
    jl, _ = jdec(jax.numpy.asarray(toks), jc)
    tl, _ = tdec(torch.from_numpy(toks), tc)
    _close(jl, tl)


@pytest.mark.parametrize("chunks", [1, 3])
def test_runtime_distribute_chunks_reaches_the_layer(chunks):
    """``RuntimeConfig.distribute_chunks`` reaches the MoE layer's config
    as JAX's ``moe_config`` passes it on (the replica stream's
    reduce-scatters), with every other field the layer shares."""
    from repro.models.transformer import moe_config as j_moe_config
    from repro_torch.models.transformer import moe_config

    jcfg = j_reduced(j_get_config(GLM))
    tcfg = reduced(get_config(GLM))
    jm = j_moe_config(jcfg, JRuntimeConfig(distribute_chunks=chunks),
                      JParallelCtx(mesh=None), 64)
    tm = moe_config(tcfg, RuntimeConfig(distribute_chunks=chunks),
                    ParallelCtx(), 64)
    assert tm.distribute_chunks == jm.distribute_chunks == chunks
    for f in ("ep_size", "cap_pair", "cap_slot", "d_model", "d_ff",
              "overlap_chunks", "dispatch_mode", "wire_dtype"):
        assert getattr(tm, f) == getattr(jm, f), f


def test_engine_run_until_empty_false_steps_like_jax():
    """``run(until_empty=False)`` makes one round (a prefill, then a decode
    step when due) per call in both engines: the queues, the finished
    requests and their tokens agree after every call."""
    cfg, jfns, tfns, _ = _build(GLM)
    engines = []
    for fns, ecls, ccls, rcls in ((jfns, JServingEngine, JEngineConfig,
                                   JRequest),
                                  (tfns, ServingEngine, EngineConfig, Request)):
        pre, dec, new, stack, unstack = fns
        eng = ecls(ccls(chunk_size=CHUNK, decode_batch=4, max_seq=MAX_SEQ),
                   prefill_fn=pre, decode_fn=dec, new_cache_fn=new,
                   stack_caches=stack, unstack_caches=unstack)
        for r in _requests(rcls, cfg.vocab_size)[:3]:
            eng.submit(r)
        engines.append(eng)
    rounds = 0
    while any(e.waiting or e.decoding for e in engines):
        for eng in engines:
            eng.run(until_empty=False)
        rounds += 1
        j, t = engines
        assert (len(j.waiting), len(j.decoding), len(j.finished)) == (
            len(t.waiting), len(t.decoding), len(t.finished))
        assert [r.output for r in j.finished] == [r.output for r in t.finished]
        assert [r.output for r, _ in j.decoding] == [
            r.output for r, _ in t.decoding]
    assert rounds > 1 and len(engines[1].finished) == 3
