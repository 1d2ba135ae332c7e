"""Overlap chunks and the reference dispatch engine of the port, on the CPU.

* ``chunk_bounds`` and ``chunk_occ_offsets`` against ``repro.moe.stages``.
* At one rank, in eager mode: the layer with ``overlap_chunks`` 2 and 4
  equals the unchunked layer bit for bit in ``a2a`` and ``replicated``, its
  statistics too (drops summed over the chunks, ``max_slot_load`` the
  largest chunk's); under a gradient d(sum y^2) in x and the router is bit
  for bit the unchunked one, and in the experts within 1e-5 of max|g| (the
  grouped FFN's weight gradient sums each chunk's rows apart).
* The reference engine (``dispatch_impl="reference"``, ``moe.dispatch``) is
  the fused engine bit for bit in both modes, and matches JAX's reference
  path (``repro.moe.layer`` with the same engine) within 1e-5 of max|y|;
  its own pieces (``dispatch_tokens``, ``bucket_by_slot``, ``unbucket``,
  ``combine_tokens``) equal JAX's, drops included.
* Four gloo ranks (one spawned run): chunked (C 2, the asynchronous
  exchanges) equals unchunked bit for bit in ``a2a``, ``replicated`` and on
  a 2 x 2 factored group in ``hier_a2a``; the reference engine equals the
  fused one in ``a2a`` and ``replicated``.
* ``MoEConfig``'s refusals of chunks or a wire codec on the reference
  engine, and ``moe_config``'s degradation of both.
"""

import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.balancer import BalancerConfig
from repro_torch.moe import stages
from repro_torch.moe.gating import GatingConfig
from repro_torch.moe.layer import MoEConfig, init_moe_params, moe_layer_local

ROOT = Path(__file__).resolve().parents[1]
E, K, D, F, T = 16, 4, 32, 48, 64
STAT_FIELDS = ("drops_dispatch", "drops_slot", "pre_max", "post_max",
               "counts")
GRADS = ("x", "router", "w1", "w3", "w2", "shared_w1")


def _cfg(mode="a2a", ep=1, **kw):
    return MoEConfig(gating=GatingConfig(num_experts=E, top_k=K),
                     balancer=BalancerConfig(mode="ultraep", n_slot=2),
                     d_model=D, d_ff=F, ep_size=ep, cap_pair=T * K,
                     cap_slot=T * K, n_shared_experts=1, shared_d_ff=16,
                     dispatch_mode=mode, **kw)


def _layer_inputs(seed=1):
    cfg = _cfg()
    params = init_moe_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    # Lean toward experts 0-2, so slots fill unevenly across chunks.
    lean = params.router[:, :3].sum(dim=1)
    x = torch.randn((T, D), generator=torch.Generator().manual_seed(seed))
    return params, x + lean / lean.norm()


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_chunk_helpers_match_jax(n):
    import jax.numpy as jnp

    from repro.moe import stages as js

    assert stages.chunk_bounds(T, n_chunks=n) == js.chunk_bounds(T,
                                                                 n_chunks=n)
    assert stages.chunk_bounds(70, chunk_size=16) == js.chunk_bounds(
        70, chunk_size=16)
    ids = np.random.default_rng(n).integers(0, E, (T, K))
    np.testing.assert_array_equal(
        stages.chunk_occ_offsets(torch.from_numpy(ids), n, E).numpy(),
        np.asarray(js.chunk_occ_offsets(jnp.asarray(ids), n, E)))


@pytest.mark.parametrize("mode", ["a2a", "replicated"])
@pytest.mark.parametrize("chunks", [2, 4])
def test_chunked_equals_unchunked_bitwise(mode, chunks):
    params, x = _layer_inputs()
    cfg = _cfg(mode)
    y0, _, s0 = moe_layer_local(x, params, cfg)
    y, _, s = moe_layer_local(
        x, params, dataclasses.replace(cfg, overlap_chunks=chunks))
    assert torch.equal(y, y0)
    for f in STAT_FIELDS:
        assert torch.equal(getattr(s, f), getattr(s0, f)), f
    # Each chunk holds a share of a slot's rows; the largest chunk's load
    # is at most the whole batch's and at least its share.
    assert s.max_slot_load <= s0.max_slot_load
    assert s.max_slot_load * chunks >= s0.max_slot_load


def _grads(params, x, cfg):
    params.requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    y, _, _ = moe_layer_local(xg, params, cfg)
    (y ** 2).sum().backward()
    out = [xg.grad] + [getattr(params, n).grad.clone() for n in GRADS[1:]]
    for t in params.parameters():
        t.grad = None
    params.requires_grad_(False)
    return dict(zip(GRADS, out))


@pytest.mark.parametrize("mode", ["a2a", "replicated"])
@pytest.mark.parametrize("chunks", [2, 4])
def test_chunked_gradients_equal_unchunked(mode, chunks):
    params, x = _layer_inputs()
    cfg = _cfg(mode)
    g0 = _grads(params, x, cfg)
    g = _grads(params, x, dataclasses.replace(cfg, overlap_chunks=chunks))
    for n in ("x", "router", "shared_w1"):
        assert torch.equal(g[n], g0[n]), n
    for n in ("w1", "w3", "w2"):
        torch.testing.assert_close(g[n], g0[n], rtol=0,
                                   atol=1e-5 * g0[n].abs().max().item())


@pytest.mark.parametrize("mode", ["a2a", "replicated"])
def test_reference_engine_equals_fused_bitwise(mode):
    params, x = _layer_inputs()
    cfg = _cfg(mode)
    y0, _, s0 = moe_layer_local(x, params, cfg)
    ref = dataclasses.replace(cfg, dispatch_impl="reference")
    y, _, s = moe_layer_local(x, params, ref)
    assert torch.equal(y, y0)
    for f in STAT_FIELDS + ("max_slot_load",):
        assert torch.equal(getattr(s, f), getattr(s0, f)), f
    # Its backward: the experts' gradients bit for bit, x's within 1e-5 of
    # max|g| (the scatters' transposes sum a token's items in another order).
    g0, g = _grads(params, x, cfg), _grads(params, x, ref)
    for n in ("router", "w1", "w3", "w2", "shared_w1"):
        assert torch.equal(g[n], g0[n]), n
    torch.testing.assert_close(g["x"], g0["x"], rtol=0,
                               atol=1e-5 * g0["x"].abs().max().item())


@pytest.mark.parametrize("mode", ["a2a", "replicated"])
def test_reference_engine_matches_jax_reference_path(mode):
    import jax.numpy as jnp

    from repro.core.balancer import BalancerConfig as JBal
    from repro.moe.gating import GatingConfig as JGate
    from repro.moe.layer import MoEConfig as JCfg
    from repro.moe.layer import MoEParams
    from repro.moe.layer import moe_layer_local as jlayer

    params, x = _layer_inputs()
    cfg = dataclasses.replace(_cfg(mode), dispatch_impl="reference")
    y, _, st = moe_layer_local(x, params, cfg)
    jcfg = JCfg(gating=JGate(num_experts=E, top_k=K),
                balancer=JBal(mode="ultraep", n_slot=2), d_model=D, d_ff=F,
                ep_size=1, cap_pair=T * K, cap_slot=T * K,
                n_shared_experts=1, shared_d_ff=16, dispatch_mode=mode,
                dispatch_impl="reference")
    jp = MoEParams(*(jnp.asarray(getattr(params, n).detach().numpy())
                     for n in ("router", "w1", "w3", "w2", "shared_w1",
                               "shared_w3", "shared_w2")))
    yj, _, sj = jlayer(jnp.asarray(x.numpy()), jp, jcfg, axis_name=None)
    yj = np.asarray(yj)
    np.testing.assert_allclose(y.numpy(), yj, rtol=0,
                               atol=1e-5 * np.abs(yj).max())
    for f in ("drops_dispatch", "drops_slot", "max_slot_load", "post_max"):
        assert int(getattr(st, f)) == int(getattr(sj, f)), f


def test_reference_pieces_match_jax():
    """dispatch_tokens / bucket_by_slot / unbucket / combine_tokens against
    ``repro.moe.dispatch`` on a tight capacity that drops, and an expert
    a receiver does not host."""
    import jax.numpy as jnp

    from repro.core.planner import solve_plan as jsolve
    from repro.moe import dispatch as jd

    from repro_torch.moe import dispatch as td

    rng = np.random.default_rng(7)
    R_, T_, k, cap = 4, 40, 3, 24
    x = rng.standard_normal((T_, 8)).astype(np.float32)
    ids = np.stack([rng.choice(E, k, replace=False) for _ in range(T_)])
    lam = rng.integers(0, 30, (R_, E))
    home = np.repeat(np.arange(R_), E // R_)
    plan = jsolve(jnp.asarray(lam), jnp.asarray(home), n_slot=2)
    q_row = np.asarray(plan.q[1])
    jo = jd.dispatch_tokens(jnp.asarray(x), jnp.asarray(ids),
                            jnp.asarray(q_row), cap_pair=cap)
    to = td.dispatch_tokens(torch.from_numpy(x), torch.from_numpy(ids),
                            torch.from_numpy(q_row), cap_pair=cap)
    for f in ("send_x", "send_e", "item_dst", "item_pos", "item_kept",
              "drops"):
        np.testing.assert_array_equal(getattr(to, f).numpy(),
                                      np.asarray(getattr(jo, f)), err_msg=f)
    assert int(to.drops) > 0
    slot_of = np.full(E, -1)
    slot_of[[0, 1, 2, 3, 5, 8]] = [0, 1, 2, 3, 4, 4]
    jb = jd.bucket_by_slot(jo.send_x, jo.send_e, jnp.asarray(slot_of),
                           num_slots=5, cap_slot=6)
    tb = td.bucket_by_slot(to.send_x, to.send_e, torch.from_numpy(slot_of),
                           num_slots=5, cap_slot=6)
    for a, b, f in zip(tb, jb, ("xs", "valid", "back_idx", "drops")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    out = rng.standard_normal((5, 6, 8)).astype(np.float32)
    ju = jd.unbucket(jnp.asarray(out), jb[1], jb[2], (R_, cap, 8))
    tu = td.unbucket(torch.from_numpy(out), tb[1], tb[2], (R_, cap, 8))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    w = rng.random((T_, k)).astype(np.float32)
    np.testing.assert_allclose(
        td.combine_tokens(tu, to, torch.from_numpy(w), T_).numpy(),
        np.asarray(jd.combine_tokens(ju, jo, jnp.asarray(w), T_)),
        rtol=0, atol=1e-6)


def test_construction_refusals_and_degradation():
    with pytest.raises(ValueError, match="overlap_chunks"):
        _cfg(overlap_chunks=0)
    with pytest.raises(ValueError, match="overlap_chunks > 1"):
        _cfg(overlap_chunks=2, dispatch_impl="reference")
    with pytest.raises(ValueError, match="wire_dtype"):
        _cfg(wire_dtype="int8", dispatch_impl="reference")
    params, x = _layer_inputs()
    with pytest.raises(ValueError, match="divide"):
        moe_layer_local(x[:63], params, _cfg(overlap_chunks=2))

    from repro_torch.configs import get_config
    from repro_torch.configs.reduce import reduced
    from repro_torch.models.transformer import (
        ParallelCtx,
        RuntimeConfig,
        moe_config,
    )

    cfg = reduced(get_config("glm45-106b-a12b"))
    m = moe_config(cfg, RuntimeConfig(overlap_chunks=4), ParallelCtx(), 64)
    assert m.overlap_chunks == 4
    assert moe_config(cfg, RuntimeConfig(overlap_chunks=3), ParallelCtx(),
                      64).overlap_chunks == 1
    ref = moe_config(cfg, RuntimeConfig(overlap_chunks=4, wire_dtype="int8",
                                        dispatch_impl="reference"),
                     ParallelCtx(), 64)
    assert (ref.overlap_chunks, ref.wire_dtype, ref.dispatch_impl) == (
        1, "none", "reference")


# ------------------------------------------------------- four gloo ranks --

RANKS = 4
# name: (group, mode, overlap chunks, engine)
GLOO_CASES = {
    "a2a": ("flat", "a2a", 1, "fused"),
    "a2a_c2": ("flat", "a2a", 2, "fused"),
    "a2a_reference": ("flat", "a2a", 1, "reference"),
    "replicated": ("flat", "replicated", 1, "fused"),
    "replicated_c2": ("flat", "replicated", 2, "fused"),
    "replicated_reference": ("flat", "replicated", 1, "reference"),
    "hier": ("hier", "hier_a2a", 1, "fused"),
    "hier_c2": ("hier", "hier_a2a", 2, "fused"),
}


def _worker(rank, world, port, out_dir):
    torch.set_num_threads(1)
    from repro_torch.parallel import collectives

    groups = {"flat": collectives.init(
        "gloo", world_size=world, rank=rank,
        init_method=f"tcp://localhost:{port}", timeout_s=120)}
    groups["hier"] = collectives.factor(2)
    base = _cfg(ep=world)
    params = init_moe_params(base, torch.Generator().manual_seed(0),
                             device="cpu", ep_rank=rank)
    x_all = torch.randn((world * T, D),
                        generator=torch.Generator().manual_seed(3))
    out = {}
    for name, (group, mode, chunks, impl) in GLOO_CASES.items():
        cfg = dataclasses.replace(base, dispatch_mode=mode,
                                  overlap_chunks=chunks, dispatch_impl=impl,
                                  racks=2 if group == "hier" else 1)
        x = x_all if mode == "replicated" else x_all[rank * T:(rank + 1) * T]
        y, _, st = moe_layer_local(x, params, cfg, axis_name=groups[group])
        out[f"{name}/y"] = y.numpy()
        for f in STAT_FIELDS + ("max_slot_load",):
            out[f"{name}/{f}"] = getattr(st, f).numpy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    collectives.destroy()


def _spawn(out_dir):
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_worker, args=(RANKS, port, out_dir), nprocs=RANKS, join=True)


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("overlap")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", f"from tests.test_torch_overlap import _spawn; "
                               f"_spawn({str(tmp)!r})"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(RANKS)]


@pytest.mark.parametrize("name,base", [
    ("a2a_c2", "a2a"), ("replicated_c2", "replicated"), ("hier_c2", "hier"),
    ("a2a_reference", "a2a"), ("replicated_reference", "replicated"),
    ("hier", "a2a")])
def test_gloo_variants_equal_their_base_bitwise(gloo_run, name, base):
    # The factored group's plan is rack-aware: only its y and drops need be
    # the flat plan's.
    same_plan = name.startswith("hier") == base.startswith("hier")
    for r in gloo_run:
        np.testing.assert_array_equal(r[f"{name}/y"], r[f"{base}/y"])
        for f in ("drops_dispatch", "drops_slot", "counts") + (
                ("post_max",) if same_plan else ()):
            np.testing.assert_array_equal(r[f"{name}/{f}"], r[f"{base}/{f}"],
                                          err_msg=f)
        assert r[f"{name}/drops_dispatch"] + r[f"{name}/drops_slot"] == 0
