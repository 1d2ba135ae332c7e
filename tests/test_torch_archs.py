"""The eight model hosts the port gained last, and the two frontend stubs,
against the JAX package on the CPU.

* Every registered arch (19): the port's ``ModelConfig`` equals the JAX
  one field for field.
* DBRX-132B, Qwen2-72B, Mistral-Large-123B, InternLM2-1.8B, Qwen3-0.6B,
  Mamba2-130M, HuBERT-XLarge and InternVL2-26B at their reduced configs
  (``reduced``: the family's structure at d_model 64, 2 layers), and the
  frontend stubs ``tiny-audio`` and ``tiny-vlm``: JAX parameters
  (``repro.models.model.init_lm``, scan_layers=True) carried across by
  ``repro_torch.convert``, the same numpy batch (tokens, or HuBERT's
  frame embeddings, or InternVL2's patch embeddings spliced over the
  first positions) through both ``forward``s: logits and aux within 1e-4
  (``tests/test_torch_model.py``'s fp32 tolerance), drops and per-layer
  expert counts equal.
* The archs that decode: a ragged prompt prefilled in chunks of 64 and a
  batched decode step through both packages' engine functions
  (``repro.serving.adapter`` / ``repro_torch.serving.adapter``), logits
  within 1e-4; InternVL2 serves text tokens in both.
* HuBERT-XLarge and InternVL2-26B, whose frontends are new: one train
  step's loss and every parameter's gradient (``frontend_proj`` among them)
  against ``jax.value_and_grad`` of the reference step's loss, each within
  1e-4 of its tensor's max|ref| (``tests/test_torch_train.py``'s bound).

XLA compiles the reference's functions here with most optimisations off
(restored after the module): that halves the compile time, which is most
of these tests' time, and the reference's results stay within the
tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.configs.reduce import reduced as j_reduced
from repro.core.balancer import BalancerConfig as JBalancerConfig
from repro.models import model as jmodel
from repro.models.transformer import ParallelCtx as JParallelCtx
from repro.models.transformer import RuntimeConfig as JRuntimeConfig
from repro.serving.adapter import make_engine_fns as j_make_engine_fns
from repro_torch import convert
from repro_torch.configs import ASSIGNED_ARCHS, PAPER_ARCHS, get_config
from repro_torch.configs import list_archs
from repro_torch.configs.reduce import reduced
from repro_torch.core.balancer import BalancerConfig
from repro_torch.models import model as tmodel
from repro_torch.models.transformer import ParallelCtx, RuntimeConfig
from repro_torch.serving.adapter import make_engine_fns
from repro_torch.train import loop as tloop

NEW = ["dbrx-132b", "qwen2-72b", "mistral-large-123b", "internlm2-1.8b",
       "qwen3-0.6b", "mamba2-130m", "hubert-xlarge", "internvl2-26b"]
STUBS = ["tiny-audio", "tiny-vlm"]
TOL = 1e-4
B, S = 2, 32
CHUNK, MAX_SEQ = 64, 160


@pytest.fixture(scope="module", autouse=True)
def _quick_xla():
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


def test_registry_matches_jax():
    import repro.configs as jconfigs

    assert list_archs() == j_list_archs()
    assert ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    assert PAPER_ARCHS == jconfigs.PAPER_ARCHS


@pytest.mark.parametrize("arch", j_list_archs())
def test_config_matches_jax_field_for_field(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(j_get_config(arch))


@pytest.fixture(scope="module")
def built():
    """``built(arch)``: ``_build(arch)``, made once for the module's tests."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = _build(arch)
        return cache[arch]

    yield get
    cache.clear()


def _build(arch):
    """Reduced configs (a tiny arch as it is), JAX params and the port's
    converted copy, fp32."""
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    if arch not in STUBS:
        jcfg, tcfg = j_reduced(jcfg), reduced(tcfg)
    n_slot = tcfg.moe.n_slot if tcfg.moe else 2
    jrcfg = JRuntimeConfig(
        balancer=JBalancerConfig(mode="ultraep", n_slot=n_slot),
        cf_pair=4.0, cf_slot=4.0, scan_layers=True, remat=False)
    trcfg = RuntimeConfig(balancer=BalancerConfig(mode="ultraep",
                                                  n_slot=n_slot),
                          cf_pair=4.0, cf_slot=4.0)
    jparams = jmodel.init_lm(jax.random.PRNGKey(0), jcfg, jrcfg,
                             JParallelCtx(mesh=None))
    tparams = convert.lm_params(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, tcfg, jrcfg, trcfg, jparams, tparams


def _batch(cfg, seed=0):
    """numpy batch: tokens and targets, or frames in place of the tokens,
    or patches beside them."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "audio_frames":
        b["frames"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
        del b["tokens"]
    if cfg.frontend == "vision_patches":
        b["patches"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return b


def _tb(b):
    return {k: torch.from_numpy(v).to(torch.int64 if v.dtype == np.int32
                                      else torch.float32)
            for k, v in b.items()}


def _close(t, j, name, tol=TOL):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    scale = max(np.abs(j).max(), 1e-30)
    err = np.abs(t - j).max()
    assert err <= tol * scale, f"{name}: max|err| {err:.3e} > {tol} * {scale:.3e}"


@pytest.mark.parametrize("arch", NEW + STUBS)
def test_forward_matches_jax(arch, built):
    jcfg, tcfg, jrcfg, trcfg, jparams, tparams = built(arch)
    b = _batch(tcfg)
    jbias = jmodel.init_router_bias(jcfg)
    tbias = tmodel.init_router_bias(tcfg, device="cpu")
    jl, jaux, jdrops, jcounts = jax.jit(
        lambda p, x: jmodel.forward(p, x, jcfg, jrcfg, JParallelCtx(mesh=None),
                                    router_bias=jbias))(
        jparams, {k: jnp.asarray(v) for k, v in b.items()})
    with torch.no_grad():
        tl, taux, tdrops, tcounts = tmodel.forward(
            tparams, _tb(b), tcfg, trcfg, ParallelCtx(), router_bias=tbias)
    assert tl.shape == (B, S, tcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(taux.numpy(), np.asarray(jaux), rtol=TOL,
                               atol=TOL)
    assert int(tdrops) == int(jdrops)
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))


@pytest.mark.parametrize("arch", [a for a in NEW + STUBS
                                  if get_config(a).has_decode])
def test_prefill_and_decode_match_jax(arch, built):
    jcfg, tcfg, jrcfg, trcfg, jparams, tparams = built(arch)
    jpre, jdec, jnew, jstack, _ = j_make_engine_fns(
        jparams, jcfg, jrcfg, JParallelCtx(mesh=None), max_seq=MAX_SEQ)
    tpre, tdec, tnew, tstack, _ = make_engine_fns(
        tparams, tcfg, trcfg, ParallelCtx(), max_seq=MAX_SEQ)
    rng = np.random.default_rng(1)
    j_caches, t_caches = [], []
    for length in (90, 40):               # two chunks, then one ragged chunk
        prompt = rng.integers(0, tcfg.vocab_size, size=length).astype(np.int32)
        jc, tc = jnew(1), tnew(1)
        for pos in range(0, length, CHUNK):
            n = min(CHUNK, length - pos)
            toks = np.pad(prompt[pos:pos + n], (0, CHUNK - n))[None, :]
            jl, jc = jpre(jnp.asarray(toks), jc, pos, n)
            tl, tc = tpre(torch.from_numpy(toks), tc, pos, n)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                       atol=TOL)
        j_caches.append(jc)
        t_caches.append(tc)
    toks = rng.integers(0, tcfg.vocab_size, size=(2, 1)).astype(np.int32)
    jl, _ = jdec(jnp.asarray(toks), jstack(j_caches))
    tl, _ = tdec(torch.from_numpy(toks), tstack(t_caches))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ["hubert-xlarge", "internvl2-26b"])
def test_train_step_gradients_match_jax(arch, built):
    jcfg, tcfg, jrcfg, trcfg, jparams, tparams = built(arch)
    b = _batch(tcfg, seed=2)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    pctx = JParallelCtx(mesh=None)

    def loss_fn(params):
        logits, aux, _, _ = jmodel.forward(params, jb, jcfg, jrcfg, pctx)
        return jmodel.lm_loss(logits, jb["targets"]) + aux

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    jnamed = dict(convert.lm_params(jax.tree.map(np.asarray, jgrads), tcfg,
                                    device="cpu").named_parameters())
    tparams.requires_grad_(True)
    try:
        tloss, _, _, tgrads = tloop.loss_and_grads(tparams, _tb(b), tcfg,
                                                   trcfg, ParallelCtx())
    finally:
        tparams.requires_grad_(False)     # the module's other tests share it
    names = [n for n, _ in tparams.named_parameters()]
    assert names == list(jnamed) and "frontend_proj" in names
    _close(tloss, jloss, "loss")
    for n, g in zip(names, tgrads):
        _close(g, jnamed[n].detach(), f"grad {n}")
