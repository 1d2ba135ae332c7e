"""Port ``moe_layer_local`` vs ``repro.moe.layer.moe_layer_local`` at the
``examples/quickstart.py`` shapes (T 256, D 64, F 128, E 64, k 4), with the
same numpy weights in both.  y within 1e-5 (fp32; the CPU path of the
grouped FFN is the plain fp32 einsum), MoEStats integers exact.  The same
holds with the wire codec and the w8a8 FFN on: y within 1e-5 * max|y|.
The buckets' per-slot row counts (``rows``) describe their validity masks
exactly (a seeded hypothesis property), and ``grouped_ffn`` with ``rows``
equals the JAX ``grouped_ffn`` within 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.balancer import BalancerConfig as JBalancerConfig
from repro.moe.gating import GatingConfig as JGatingConfig
from repro.moe.layer import MoEConfig as JMoEConfig
from repro.moe.layer import MoEParams as JMoEParams
from repro.moe.expert import grouped_ffn as j_grouped_ffn
from repro.moe.layer import moe_layer_local as j_moe_layer_local
from repro_torch.analysis import plan_check
from repro_torch import convert
from repro_torch.moe import stages
from repro_torch.moe.expert import grouped_ffn
from repro_torch.core.balancer import BalancerConfig
from repro_torch.moe.gating import GatingConfig, gate
from repro_torch.moe.layer import MoEConfig, moe_layer_local
from repro_torch.moe.reference import moe_ref

T, D, F, E, K = 256, 64, 128, 64, 4
STAT_FIELDS = ("drops_dispatch", "drops_slot", "pre_max", "post_max",
               "max_slot_load", "counts")


@pytest.fixture(autouse=True)
def _verify_plans():
    """Every plan the port's balancer solves here goes through its static
    check (``repro_torch.analysis.plan_check``), as the reference's
    tests/conftest.py does for the JAX package's."""
    with plan_check.plan_verification():
        yield


def _params(shared: bool, seed=0):
    rng = np.random.default_rng(seed)

    def n(shape, fan_in):
        return (rng.standard_normal(shape) * fan_in ** -0.5).astype(np.float32)

    sh = (n((D, F), D), n((D, F), D), n((F, D), F)) if shared else (None,) * 3
    return JMoEParams(n((D, E), D), n((E, D, F), D), n((E, D, F), D),
                      n((E, F, D), F), *sh)


def _configs(mode, balancer, shared, cap):
    kw = dict(d_model=D, d_ff=F, ep_size=1, cap_pair=cap[0], cap_slot=cap[1],
              n_shared_experts=int(shared), shared_d_ff=F if shared else 0,
              dispatch_mode=mode)
    j = JMoEConfig(gating=JGatingConfig(num_experts=E, top_k=K),
                   balancer=JBalancerConfig(mode=balancer, n_slot=2), **kw)
    t = MoEConfig(gating=GatingConfig(num_experts=E, top_k=K),
                  balancer=BalancerConfig(mode=balancer, n_slot=2), **kw)
    return j, t


@pytest.mark.parametrize("mode", ["a2a", "replicated"])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("balancer,cap", [("ultraep", (T * K, T * K)),
                                          ("none", (T * K, 12))])
def test_moe_layer_matches_jax(mode, shared, balancer, cap):
    p = _params(shared)
    x = np.random.default_rng(1).standard_normal((T, D)).astype(np.float32)
    jcfg, tcfg = _configs(mode, balancer, shared, cap)
    jp = JMoEParams(*(None if a is None else jnp.asarray(a) for a in p))
    yj, auxj, sj = jax.jit(lambda x: j_moe_layer_local(
        x, jp, jcfg, axis_name=None))(jnp.asarray(x))
    tp = convert.moe_params(p, n_slot=2, device="cpu")
    yt, auxt, st = moe_layer_local(torch.from_numpy(x), tp, tcfg)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(auxt), float(auxj), rtol=1e-5)
    for f in STAT_FIELDS:
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(sj, f)), err_msg=f)
    if cap[1] == T * K:      # zero drops: the layer equals the dense oracle
        assert int(st.drops_dispatch) == int(st.drops_slot) == 0
        go = gate(torch.from_numpy(x), tp.router, tcfg.gating)
        shared_w = ((tp.shared_w1, tp.shared_w3, tp.shared_w2) if shared
                    else None)
        y_ref = moe_ref(torch.from_numpy(x), go.expert_ids, go.weights,
                        tp.w1, tp.w3, tp.w2, shared=shared_w)
        np.testing.assert_allclose(yt.numpy(), y_ref.numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("mode", ["a2a", "replicated"])
@pytest.mark.parametrize("wire,ffn", [("bf16", "none"), ("int8", "none"),
                                      ("int8", "int8")])
def test_quantized_moe_layer_matches_jax(mode, wire, ffn):
    """The wire codec (a2a both ways, and the replica stream) and the w8a8
    FFN; routing is decided before encoding, so every stat is equal."""
    p = _params(True)
    x = np.random.default_rng(1).standard_normal((T, D)).astype(np.float32)
    jcfg, tcfg = (dataclasses.replace(c, wire_dtype=wire, ffn_dtype=ffn)
                  for c in _configs(mode, "ultraep", True, (T * K, T * K)))
    jp = JMoEParams(*(None if a is None else jnp.asarray(a) for a in p))
    yj, _, sj = jax.jit(lambda x: j_moe_layer_local(
        x, jp, jcfg, axis_name=None))(jnp.asarray(x))
    tp = convert.moe_params(p, n_slot=2, device="cpu")
    yt, _, st = moe_layer_local(torch.from_numpy(x), tp, tcfg)
    for f in STAT_FIELDS:
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(sj, f)), err_msg=f)
    assert int(st.drops_dispatch) == int(st.drops_slot) == 0
    yj = np.asarray(yj)
    tol = 1e-5 * np.abs(yj).max()
    if ffn == "int8":
        # The two frameworks' silu differ by an ulp on part of the gate's
        # outputs, which can carry an activation across a rounding boundary
        # of its int8 code: one code step is max|act row| / 127, which
        # moves that token's output by well under 1e-3 * max|y|.  Every
        # other token is held to 1e-5.
        moved = (np.abs(yt.numpy() - yj) > tol).any(axis=1)
        assert moved.sum() <= T // 100, moved.sum()
        tol = 1e-3 * np.abs(yj).max()
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0, atol=tol)
    if ffn == "int8":     # the mains' codes are kept, the tail recomputed
        w1q, w1s = tp.q8_slot_buffers()[0]
        assert w1q.stride(1) == 1 and w1q.shape == (E + 2, D, F)


def test_moe_config_rejects_unknown_dtypes():
    _, tcfg = _configs("a2a", "ultraep", False, (8, 8))
    with pytest.raises(ValueError, match="wire_dtype"):
        dataclasses.replace(tcfg, wire_dtype="fp8")
    with pytest.raises(ValueError, match="ffn_dtype"):
        dataclasses.replace(tcfg, ffn_dtype="bf16")


def test_slot_buffer_tail_is_written_in_place():
    """The replica tail of the slot buffer is the only thing a call writes;
    the mains are the head of the same storage."""
    p = _params(False)
    tp = convert.moe_params(p, n_slot=2, device="cpu")
    w1_all, _, _ = tp.slot_buffers()
    assert w1_all.shape[0] == E + 2
    assert w1_all.data_ptr() == tp.w1.data_ptr()
    tp.w1 = torch.nn.Parameter(tp.w1.clone(), requires_grad=False)
    with pytest.raises(RuntimeError):
        tp.slot_buffers()


@settings(max_examples=30, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), cap_slot=st.integers(1, 48),
       mode=st.sampled_from(["a2a", "replicated"]),
       balancer=st.sampled_from(["ultraep", "none"]))
def test_bucket_rows_are_the_valid_prefix(seed, cap_slot, mode, balancer):
    """What the kernels rely on: each slot's valid rows are the prefix
    ``arange(cap_slot) < rows`` and ``rows == valid.sum(1)``, from both
    buckets, with and without drops at slot capacity."""
    _, tcfg = _configs(mode, balancer, False, (T * K, cap_slot))
    tp = convert.moe_params(_params(False), n_slot=2, device="cpu")
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32)
                         * rng.uniform(0.5, 4.0))
    ctx = stages.make_stage_ctx(tcfg, None)
    gs = stages.gate_stage(ctx, x, tp.router)
    ps = stages.plan_stage(ctx, gs)
    ds = stages.dispatch_stage(ctx, x, gs.gate_out.expert_ids, gs, ps)
    assert ds.rows.shape == (tcfg.layout.slots_per_rank,)
    assert torch.equal(ds.rows, ds.valid.sum(dim=1))
    p = torch.arange(ds.valid.shape[1])
    assert torch.equal(ds.valid, p[None, :] < ds.rows[:, None])
    assert not ds.xs[~ds.valid].any()


@pytest.mark.parametrize("junk,ffn_dtype,wire", [
    pytest.param(False, "none", False, id="False"),
    pytest.param(True, "none", False, id="True"),
    pytest.param(False, "int8", False, id="int8-False"),
    pytest.param(True, "int8", False, id="int8-True"),
    pytest.param(False, "int8", True, id="int8-wire-False"),
    pytest.param(True, "int8", True, id="int8-wire-True")])
def test_grouped_ffn_rows_matches_jax(junk, ffn_dtype, wire):
    """Slot buffers whose rows past each count are zero (as the buckets
    build them) through the JAX ``grouped_ffn`` and through the port's with
    ``rows``, in fp and w8a8 (``wire``: the slot buffers arrive as int8
    wire codes, a view with rows D + 4 bytes apart, and their scales); with
    ``junk`` the port's padded rows hold NaN (wire: random codes and NaN
    scales), which the kernels' row counts must keep out of the output."""
    from repro_torch.core.quantize import encode_wire, split_wire_int8

    rng = np.random.default_rng(2)
    G, C = 6, 24
    rows = np.array([0, 5, 24, 13, 1, 16])
    valid = np.arange(C)[None, :] < rows[:, None]
    xs = (rng.standard_normal((G, C, D))
          * valid[:, :, None]).astype(np.float32)
    ws = [(rng.standard_normal(shape) * shape[1] ** -0.5).astype(np.float32)
          for shape in ((G, D, F), (G, D, F), (G, F, D))]
    xs_t, scale_t, j_in = torch.from_numpy(xs), None, {}
    if wire:
        xs_t, scale_t = split_wire_int8(encode_wire(xs_t, "int8"))
        j_in = dict(xs_scale=jnp.asarray(scale_t.numpy()))
        xs = xs_t.numpy().copy()
    y_j = np.asarray(j_grouped_ffn(jnp.asarray(xs), jnp.asarray(valid),
                                   *map(jnp.asarray, ws), ffn_dtype=ffn_dtype,
                                   **j_in))
    pad = torch.from_numpy(~valid)
    if junk and wire:
        xs_t[pad] = torch.from_numpy(
            rng.integers(-127, 128, (int(pad.sum()), D), dtype=np.int8))
        scale_t[pad] = float("nan")
    elif junk:
        xs_t[pad] = float("nan")
    y_t = grouped_ffn(xs_t, torch.from_numpy(valid),
                      *map(torch.from_numpy, ws), ffn_dtype=ffn_dtype,
                      xs_scale=scale_t, rows=torch.from_numpy(rows))
    assert not y_t.numpy()[~valid].any()               # padded rows zero
    np.testing.assert_allclose(y_t.numpy(), y_j, rtol=1e-5,
                               atol=1e-5 * np.abs(y_j).max())


@pytest.mark.parametrize("mode", ["a2a", "replicated"])
@pytest.mark.parametrize("balancer,cap", [("ultraep", (T * K, T * K)),
                                          ("none", (T * K, 12))])
def test_moe_layer_gradients_match_jax(mode, balancer, cap):
    """d(sum y^2 + aux) in x, the router, the experts and the shared
    expert, against ``jax.grad`` of the JAX layer (the fused engine, as
    ``tests/test_permute.py``'s gradient test): the gradients through the
    gathers of dispatch, bucket, unbucket and combine (tokens and combine
    weights), with items dropped at a tight slot capacity too."""
    p = _params(True)
    x = np.random.default_rng(2).standard_normal((T, D)).astype(np.float32)
    jcfg, tcfg = _configs(mode, balancer, True, cap)

    def jloss(x, *ws):
        y, aux, _ = j_moe_layer_local(x, JMoEParams(*ws), jcfg,
                                      axis_name=None)
        return (y ** 2).sum() + aux

    jg = jax.jit(jax.grad(jloss, argnums=tuple(range(8))))(
        jnp.asarray(x), *(jnp.asarray(a) for a in p))
    tp = convert.moe_params(p, n_slot=2, device="cpu")
    tp.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux, _ = moe_layer_local(xt, tp, tcfg)
    ((y ** 2).sum() + aux).backward()
    got = [xt.grad] + [t.grad for t in (tp.router, tp.w1, tp.w3, tp.w2,
                                        tp.shared_w1, tp.shared_w3,
                                        tp.shared_w2)]
    for name, a, b in zip(("x", "router", "w1", "w3", "w2", "sw1", "sw3",
                           "sw2"), got, jg):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * np.abs(b).max(), err_msg=name)
