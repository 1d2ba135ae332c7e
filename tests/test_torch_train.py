"""Training: the port's train step against the JAX package's, on the CPU.

A reduced GLM-4.5-Air (2 layers, d_model 64, 16 experts top-4, fp32, the
``ultraep`` balancer at capacity factors 4.0) from ``repro.models.model.
init_lm``, carried across by ``repro_torch.convert``, takes the same
``SyntheticLMStream`` batch in both packages:

* one ``make_train_step``: the loss, every parameter's gradient (the JAX
  one from ``jax.grad`` of the step's own loss), both AdamW moments, the
  router bias (with ``use_bias`` on) and the updated parameters, each
  within 1e-4 of its tensor's max|ref|; counts and drops equal.  Adam's
  first update is about lr sign(g), so the updated parameters are compared
  only where |g| exceeds 1e-3 of the tensor's max|g|, where the sign is
  not decided by rounding;
* three steps: the losses within 1e-4; ``microbatches=2`` against JAX's and,
  with the aux loss off (the GShard loss of a batch is not the mean of its
  halves'), against the port's one microbatch;
* the optimizer pieces alone, the bias update, the data stream (bitwise),
  the bias's missing gradient, and the autograd Functions of the kernels
  (their CPU backward against autograd of the plain forward, ``gradcheck``
  in fp64).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.reduce import reduced as j_reduced
from repro.core.balancer import BalancerConfig as JBalancerConfig
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLMStream as JStream
from repro.models import model as jmodel
from repro.models.transformer import ParallelCtx as JParallelCtx
from repro.models.transformer import RuntimeConfig as JRuntimeConfig
from repro.moe.gating import update_router_bias as j_update_router_bias
from repro.optim import optimizer as jopt
from repro.train import loop as jloop
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.reduce import reduced
from repro_torch.core.balancer import BalancerConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.gating_topk import ops as gating_ops
from repro_torch.kernels.grouped_gemm import ops as gg
from repro_torch.models.transformer import ParallelCtx, RuntimeConfig
from repro_torch.moe import distribute
from repro_torch.moe.gating import update_router_bias
from repro_torch.optim import optimizer as topt
from repro_torch.train import loop as tloop

GLM = "glm45-106b-a12b"
TOL = 1e-4
BATCH, SEQ = 2, 32
LR = dict(base_lr=3e-3, warmup=0, total=10)


def _cfgs(use_bias=False, aux=None):
    jcfg = j_reduced(j_get_config(GLM))
    tcfg = reduced(get_config(GLM))
    moe = {"use_bias": use_bias}
    if aux is not None:
        moe["aux_loss_weight"] = aux
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, **moe))
    return jcfg, tcfg


def _setup(use_bias=False, loss_chunks=1, microbatches=1, aux=None, cf=4.0):
    jcfg, tcfg = _cfgs(use_bias, aux)
    jrcfg = JRuntimeConfig(balancer=JBalancerConfig(mode="ultraep", n_slot=2),
                           cf_pair=cf, cf_slot=cf, scan_layers=True,
                           remat=False, loss_chunks=loss_chunks)
    trcfg = RuntimeConfig(balancer=BalancerConfig(mode="ultraep", n_slot=2),
                          cf_pair=cf, cf_slot=cf, loss_chunks=loss_chunks)
    jparams = jmodel.init_lm(jax.random.PRNGKey(0), jcfg, jrcfg,
                             JParallelCtx(mesh=None))
    tparams = convert.lm_params(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    jo = jopt.adamw(jopt.cosine_schedule(**LR))
    to = topt.adamw(topt.cosine_schedule(**LR))
    jstate = jloop.init_train_state(jparams, jo, jcfg)
    tstate = tloop.init_train_state(tparams, to, tcfg)
    jstep = jax.jit(jloop.make_train_step(
        jcfg, jrcfg, JParallelCtx(mesh=None), jo,
        jloop.TrainConfig(microbatches=microbatches)))
    tstep = tloop.make_train_step(tcfg, trcfg, ParallelCtx(), to,
                                  tloop.TrainConfig(microbatches=microbatches))
    stream = JStream(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=SEQ,
                                 global_batch=BATCH, seed=0))
    return dict(jcfg=jcfg, tcfg=tcfg, jrcfg=jrcfg, trcfg=trcfg,
                jstate=jstate, tstate=tstate, jstep=jstep, tstep=tstep,
                stream=stream)


def _tbatch(b):
    return {k: torch.from_numpy(v).to(torch.int64) for k, v in b.items()}


def _named(tree, tcfg):
    """A JAX tree shaped like LMParams (params, grads or moments) as the
    port's named tensors."""
    mod = convert.lm_params(jax.tree.map(np.asarray, tree), tcfg,
                            device="cpu")
    return dict(mod.named_parameters())


def _close(t, j, name, tol=TOL):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    scale = max(np.abs(j).max(), 1e-30)
    err = np.abs(t - j).max()
    assert err <= tol * scale, f"{name}: max|err| {err:.3e} > {tol} * {scale:.3e}"


def _jax_grads(s, batch):
    """jax.grad of the JAX step's own loss (repro.train.loop's loss_fn)."""
    jcfg, jrcfg = s["jcfg"], s["jrcfg"]
    pctx = JParallelCtx(mesh=None)

    def loss_fn(params):
        if jrcfg.loss_chunks > 1:
            x, aux, _, _ = jmodel.forward(params, batch, jcfg, jrcfg, pctx,
                                          router_bias=s["jstate"].router_bias,
                                          return_hidden=True)
            return jmodel.blocked_lm_loss(x, params.lm_head, batch["targets"],
                                          chunks=jrcfg.loss_chunks) + aux
        logits, aux, _, _ = jmodel.forward(params, batch, jcfg, jrcfg, pctx,
                                           router_bias=s["jstate"].router_bias)
        return jmodel.lm_loss(logits, batch["targets"]) + aux

    return jax.jit(jax.grad(loss_fn))(s["jstate"].params)


@pytest.mark.parametrize("use_bias,loss_chunks", [(False, 1), (True, 4)])
def test_one_train_step_matches_jax(use_bias, loss_chunks):
    s = _setup(use_bias=use_bias, loss_chunks=loss_chunks)
    b = s["stream"].batch(0)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = _tbatch(b)
    jgrads = _named(_jax_grads(s, jb), s["tcfg"])
    tparams = s["tstate"].params
    tloss, tdrops, tcounts, tgrads = tloop.loss_and_grads(
        tparams, tb, s["tcfg"], s["trcfg"], ParallelCtx(),
        router_bias=s["tstate"].router_bias)
    names = [n for n, _ in tparams.named_parameters()]
    assert names == list(jgrads)
    grads = {n: g.clone() for n, g in zip(names, tgrads)}
    for n in names:
        _close(grads[n], jgrads[n].detach(), f"grad {n}")
    old = {n: p.detach().clone() for n, p in tparams.named_parameters()}

    jstate, jm = s["jstep"](s["jstate"], jb)
    tstate, tm = s["tstep"](s["tstate"], tb)
    _close(tm["loss"], jm["loss"], "loss")
    _close(tloss, jm["loss"], "loss (loss_and_grads)")
    assert int(tm["drops"]) == int(jm["drops"]) == int(tdrops)
    np.testing.assert_array_equal(tm["counts"].numpy(), np.asarray(jm["counts"]))
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jm["counts"]))
    _close(tm["grad_norm"], jm["grad_norm"], "grad_norm")
    jmu = _named(jstate.opt_state.mu, s["tcfg"])
    jnu = _named(jstate.opt_state.nu, s["tcfg"])
    jnew = _named(jstate.params, s["tcfg"])
    for i, (n, p) in enumerate(tstate.params.named_parameters()):
        _close(tstate.opt_state.mu[i], jmu[n].detach(), f"mu {n}")
        _close(tstate.opt_state.nu[i], jnu[n].detach(), f"nu {n}")
        g = grads[n].abs()
        sure = g > 1e-3 * g.max()
        _close(p.detach()[sure], jnew[n].detach()[sure], f"param {n}")
        assert not torch.equal(p.detach(), old[n]) or not sure.any(), n
    if use_bias:
        assert jstate.router_bias is not None
        _close(tstate.router_bias, jstate.router_bias, "router_bias", tol=0)
        assert np.abs(np.asarray(jstate.router_bias)).max() > 0
    else:
        assert tstate.router_bias is None and jstate.router_bias is None
    assert tstate.step == 1


def test_three_train_steps_match_jax():
    s = _setup()
    jstate, tstate = s["jstate"], s["tstate"]
    for step in range(3):
        b = s["stream"].batch(step)
        jstate, jm = s["jstep"](jstate, {k: jnp.asarray(v)
                                         for k, v in b.items()})
        tstate, tm = s["tstep"](tstate, _tbatch(b))
        _close(tm["loss"], jm["loss"], f"loss {step}")


def test_two_microbatches_match_jax_and_one_microbatch():
    s = _setup(microbatches=2)
    b = s["stream"].batch(0)
    _, jm = s["jstep"](s["jstate"], {k: jnp.asarray(v) for k, v in b.items()})
    _, tm = s["tstep"](s["tstate"], _tbatch(b))
    _close(tm["loss"], jm["loss"], "loss, 2 microbatches")
    np.testing.assert_array_equal(tm["counts"].numpy(), np.asarray(jm["counts"]))
    # Without the aux loss, and with capacity for every item (a microbatch's
    # slots are half the size), the mean of the halves' gradients is the
    # whole batch's gradient.
    grads = []
    for mb in (1, 2):
        s = _setup(microbatches=mb, aux=0.0, cf=16.0)
        loss, drops, counts, g = tloop.loss_and_grads(
            s["tstate"].params, _tbatch(b), s["tcfg"], s["trcfg"],
            ParallelCtx(), tloop.TrainConfig(microbatches=mb))
        assert int(drops) == 0
        grads.append((loss, counts, [t.clone() for t in g]))
    _close(grads[1][0], grads[0][0].numpy(), "loss 2 vs 1 microbatches")
    assert torch.equal(grads[1][1], grads[0][1])
    for g2, g1 in zip(grads[1][2], grads[0][2]):
        _close(g2, g1.numpy(), "grad 2 vs 1 microbatches")


@pytest.mark.parametrize("step", [0, 3, 5, 7, 10, 12])
def test_cosine_schedule_matches_jax(step):
    j = jopt.cosine_schedule(1e-3, warmup=5, total=10)(jnp.asarray(step))
    t = topt.cosine_schedule(1e-3, warmup=5, total=10)(step)
    np.testing.assert_allclose(t, float(j), rtol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    rng = np.random.default_rng(0)
    gs = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    jg, jn = jopt.clip_by_global_norm([jnp.asarray(g) for g in gs], max_norm)
    tg, tn = topt.clip_by_global_norm([torch.from_numpy(g.copy()) for g in gs],
                                      max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_adamw_slices_large_parameters(monkeypatch):
    """The in-place update over slices is the update of the whole tensor."""
    rng = np.random.default_rng(1)
    p = rng.standard_normal(1000).astype(np.float32)
    g = rng.standard_normal(1000).astype(np.float32)
    outs = []
    for chunk in (7, 1 << 26):
        monkeypatch.setattr(topt, "CHUNK", chunk)
        opt = topt.adamw(1e-2)
        params = [torch.from_numpy(p.copy())]
        state = opt.init(params)
        for step in range(2):
            opt.update([torch.from_numpy(g)], state, params, step)
        outs.append(params[0])
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    jo = jopt.adamw(1e-2)
    js, jp = jo.init([jnp.asarray(p)]), [jnp.asarray(p)]
    for step in range(2):
        u, js = jo.update([jnp.asarray(g)], js, jp, jnp.asarray(step))
        jp = jopt.apply_updates(jp, u)
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(jp[0]), rtol=1e-6,
                               atol=1e-7)


def test_update_router_bias_matches_jax():
    rng = np.random.default_rng(2)
    bias = rng.standard_normal((3, 16)).astype(np.float32)
    counts = rng.integers(0, 50, (3, 16)).astype(np.int32)
    j = jax.vmap(lambda b, c: j_update_router_bias(b, c, 1e-3))(
        jnp.asarray(bias), jnp.asarray(counts))
    t = update_router_bias(torch.from_numpy(bias),
                           torch.from_numpy(counts).to(torch.int64), 1e-3)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("step", [0, 1, 63, 150])
def test_synthetic_stream_is_bitwise_jax(step):
    cfg = dict(vocab_size=1000, seq_len=17, global_batch=5, seed=3)
    j = JStream(JDataConfig(**cfg)).batch(step)
    t = SyntheticLMStream(DataConfig(**cfg)).batch(step)
    for k in ("tokens", "targets"):
        assert t[k].dtype == j[k].dtype
        np.testing.assert_array_equal(t[k], j[k])


def test_router_bias_gets_no_gradient():
    s = _setup(use_bias=True)
    bias = (torch.randn(s["tcfg"].num_layers, s["tcfg"].moe.num_experts,
                        generator=torch.Generator().manual_seed(0)) * 0.05
            ).requires_grad_(True)
    tloop.loss_and_grads(s["tstate"].params, _tbatch(s["stream"].batch(0)),
                         s["tcfg"], s["trcfg"], ParallelCtx(),
                         router_bias=bias)
    assert bias.grad is None
    assert s["tstate"].params.layers[1].moe.router.grad is not None


# ------------------------------------------------ autograd Functions -----

def _rows(G, M):
    return torch.tensor([(g * 5 + 3) % (M + 1) for g in range(G)])


def _grad_pair(fn_kernel, fn_plain, inputs, seed=0):
    """Gradients of sum(out * r) through the Function and through autograd
    of the plain forward, for the same random r."""
    outs = []
    for fn in (fn_kernel, fn_plain):
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        out = fn(*leaves)
        r = torch.randn(out.shape, generator=torch.Generator().manual_seed(
            seed), dtype=out.dtype)
        (out * r).sum().backward()
        outs.append([t.grad for t in leaves])
    return outs


@pytest.mark.parametrize("op", ["swiglu", "matmul"])
def test_grouped_functions_backward_matches_plain_autograd(op):
    G, M, K, N = 3, 12, 16, 8
    rows = _rows(G, M)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((G, M, K)).astype(np.float32))
    ws = [torch.from_numpy((rng.standard_normal((G, K, N)) * 0.3).astype(
        np.float32)) for _ in range(2)]
    if op == "swiglu":
        kern = lambda x, a, b: gg.grouped_swiglu(x, a, b, rows)  # noqa: E731
        plain = lambda x, a, b: gg.grouped_swiglu_ref(x, a, b, rows)  # noqa: E731
        inputs = [x, *ws]
    else:
        kern = lambda x, a: gg.grouped_matmul(x, a, rows)  # noqa: E731
        plain = lambda x, a: gg.grouped_matmul_ref(x, a, rows)  # noqa: E731
        inputs = [x, ws[0]]
    got, want = _grad_pair(kern, plain, inputs)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert torch.all(got[0][rows.shape[0] - 1, rows[-1]:] == 0)


@pytest.mark.parametrize("op", ["swiglu", "matmul"])
def test_grouped_functions_gradcheck(op):
    G, M, K, N = 2, 5, 4, 3
    rows = torch.tensor([3, 5])
    g = torch.Generator().manual_seed(5)
    x = torch.randn((G, M, K), dtype=torch.float64, generator=g,
                    requires_grad=True)
    w1, w3 = (torch.randn((G, K, N), dtype=torch.float64, generator=g,
                          requires_grad=True) for _ in range(2))
    if op == "swiglu":
        assert torch.autograd.gradcheck(
            lambda x, a, b: gg.grouped_swiglu(x, a, b, rows), (x, w1, w3))
    else:
        assert torch.autograd.gradcheck(
            lambda x, a: gg.grouped_matmul(x, a, rows), (x, w1))


def test_flash_function_backward_matches_plain_autograd():
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 12, 4, 8), (2, 12, 2, 8), (2, 12, 2, 8)))
    kern = lambda q, k, v: flash_ops.flash_attention(  # noqa: E731
        q, k, v, causal=True, block_kv=8)
    plain = lambda q, k, v: flash_ops.flash_attention_ref(  # noqa: E731
        q, k, v, causal=True, block_kv=8)
    got, want = _grad_pair(kern, plain, [q, k, v])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    q64, k64, v64 = (t.double().requires_grad_(True) for t in (q, k, v))
    assert torch.autograd.gradcheck(
        lambda q, k, v: flash_ops.flash_attention(q, k, v, causal=True,
                                                  block_kv=8),
        (q64[:1, :6], k64[:1, :6], v64[:1, :6]))


def test_flash_function_refuses_offsets_under_gradient():
    q = torch.zeros((1, 4, 2, 8), requires_grad=True)
    k = v = torch.zeros((1, 8, 2, 8))
    with pytest.raises(ValueError, match="full sequences"):
        flash_ops.flash_attention(q, k, v, causal=True, q_offset=4)


@pytest.mark.parametrize("score_fn", ["softmax", "sigmoid"])
def test_gating_function_backward_matches_plain_autograd(score_fn):
    rng = np.random.default_rng(7)
    logits = torch.from_numpy(rng.standard_normal((20, 16)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(16).astype(np.float32)) * 0.1

    def kern(lg):
        ids, w, _, sc = gating_ops.gating_topk(lg, 4, score_fn=score_fn,
                                               bias=bias, want_scores=True)
        return torch.cat([w, sc], dim=1)

    def plain(lg):
        sc = gating_ops.scores_of(lg, score_fn)
        ids = gating_ops.gating_topk_ref(lg.detach(), 4, score_fn=score_fn,
                                         bias=bias)[0]
        return torch.cat([torch.gather(sc, 1, ids), sc], dim=1)

    got, want = _grad_pair(kern, plain, [logits])
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-7)
    lg64 = logits.double().requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda lg: gating_ops.gating_topk(lg, 4, score_fn=score_fn,
                                          want_scores=True)[1], (lg64,))


def test_slot_weights_backward_reduces_replicas_onto_mains():
    """One rank: the replica slots' gradient lands on their home mains, as
    autograd of the plain copy (torch.cat of the mains and the gathered
    replica rows) gives it."""
    E, n_slot = 4, 3
    x_slots = torch.tensor([[2, -1, 2]])
    rng = np.random.default_rng(8)
    mains = torch.from_numpy(rng.standard_normal((E, 3, 2)).astype(np.float32))
    buf = torch.zeros((E + n_slot, 3, 2))
    buf[:E] = mains
    w = torch.nn.Parameter(buf[:E])
    (out,) = distribute.slot_weights((w,), (buf,), x_slots, 0, None)
    r = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    (out * r).sum().backward()
    plain = mains.clone().requires_grad_(True)
    reps = torch.where((x_slots[0] >= 0)[:, None, None],
                       plain[x_slots[0].clamp(min=0)], 0.0)
    (torch.cat([plain, reps]) * r).sum().backward()
    torch.testing.assert_close(w.grad, plain.grad, rtol=0, atol=1e-6)
    torch.testing.assert_close(out.detach()[E], mains[2])


def test_plain_backward_gives_the_same_gradients():
    """``RuntimeConfig.plain_backward`` (chip_smoke's in-place check of the
    backward kernels) runs each kernel op's backward as autograd through
    its plain forward: on the CPU, where the backward is the kernels'
    plain versions already, the two agree."""
    s = _setup()
    b = _tbatch(s["stream"].batch(0))
    runs = []
    for plain in (False, True):
        rcfg = dataclasses.replace(s["trcfg"], plain_backward=plain)
        loss, _, counts, g = tloop.loss_and_grads(
            s["tstate"].params, b, s["tcfg"], rcfg, ParallelCtx())
        runs.append((loss, counts, [t.clone() for t in g]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    for a, b_ in zip(runs[0][2], runs[1][2]):
        torch.testing.assert_close(a, b_, rtol=1e-5, atol=1e-7)
