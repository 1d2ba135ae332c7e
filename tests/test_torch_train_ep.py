"""The trainer on a mesh of data x EP ranks (gloo, CPU) against the JAX
package's train step on a mesh of virtual devices, on the reference's
layout (the one layout of a mesh: tensor parallelism over the model
axis, FSDP over the data axis, a sequence-parallel residual stream).

One run of eight processes (``torch.multiprocessing``, spawn, one gloo
world) holds every torch case, beside one JAX run on eight virtual CPU
devices (``tests.helpers.run_multidevice``) that runs every JAX mesh in
turn; the JAX run writes the inputs (the batch of the reference's own
full-model mesh test, ``tests/test_multidevice.py``, and the initial
parameters, carried across by ``repro_torch.convert``) that the torch run
reads.  The model is ``tiny-moe`` with ``ultraep``, AdamW at 1e-3, B 8, S
32, three steps on that one batch:

* ``d2e4``: ``make_test_mesh(2, 4)`` at capacity factors 8 (no drops);
  ``tight``: the same mesh at capacity factors 1, where every rank drops
  items, with the aux-free router bias on; ``rack``: ``make_rack_mesh(1,
  2, 2)`` (ranks 0-3), where the MoE blocks run ``hier_a2a``.  Per step
  the loss, the gradient norm and the router bias within 1e-5 relative,
  the global drops and counts equal, and each rank's own drops equal the
  JAX device's (a ``jax.debug.callback`` inside the island, the torch
  rank's stats beside it); after the steps every parameter within 1e-5 of
  its max|p|.  ``adafactor``: the (2, 4) mesh with Adafactor at 1e-3 in
  place of AdamW, the same checks: its update's RMS clip binds in these
  steps, and the reference takes the RMS over the whole expert tensor,
  so each EP rank's rows must be scaled by the global RMS.  Its JAX
  model keeps each layer's tensors apart (``scan_layers=False``, the same
  initial values), as the port does: Adafactor factors a stacked (L, D)
  norm, which a per-layer (D,) norm is not.  ``replicated``: the (2, 4)
  mesh on the batch's first 3 rows at capacity factors 1, a global batch
  that does not divide over the 2 data rows, so every data row runs all
  3 rows and the reference sizes the capacities from 3 // 2 rows: the
  floor binds and ranks drop, the same checks.
* ``aux0``: the (2, 4) mesh with ``aux_loss_weight`` 0: the gradients of
  the global loss (summed over the mesh) against the port's one-rank step
  on the whole batch, within 1e-5 of each tensor's max|g|.
* The gradients' sums over the 8 ranks (``reduce_grads``) cut into
  pieces of a few bytes.
* ``collectives.all_gather``, ``all_reduce`` and ``shard`` under a
  gradient on the EP group of 4 ranks.
* Adafactor over that EP group with every tensor split by rows (a 2-D
  tensor, whose column mean and v_row mean span the split, a 3-D and a
  1-D one), three steps with the clip binding: each rank's rows of the
  parameters and v_row, and the whole v_col, within 1e-5 relative of
  JAX's ``adafactor`` on the whole tensors.
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

ROOT = Path(__file__).resolve().parents[1]
WORLD, STEPS, B, S = 8, 3, 8, 32
# name: (mesh, capacity factor, use_bias, aux_loss_weight or None,
#        optimizer, rows of the batch)
CASES = {
    "d2e4": ("flat", 8.0, False, None, "adamw", B),
    "tight": ("flat", 1.0, True, None, "adamw", B),
    "rack": ("rack", 8.0, False, None, "adamw", B),
    "adafactor": ("flat", 8.0, False, None, "adafactor", B),
    "replicated": ("flat", 1.0, False, None, "adamw", 3),
}
TOL = 1e-5
LR = 1e-3
# Tensors of the EP-split Adafactor check, split by rows over 4 ranks.
FACTOR_SHAPES = ((8, 6), (8, 3, 5), (8,))


def _cfgs(cf, use_bias, aux):
    from repro_torch.configs import get_config
    from repro_torch.core.balancer import BalancerConfig
    from repro_torch.models.transformer import RuntimeConfig

    cfg = get_config("tiny-moe")
    moe = {"use_bias": use_bias}
    if aux is not None:
        moe["aux_loss_weight"] = aux
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    rcfg = RuntimeConfig(balancer=BalancerConfig(mode="ultraep", n_slot=2),
                         cf_pair=cf, cf_slot=cf)
    return cfg, rcfg


def _params(cfg, rcfg, pctx, init):
    """The port's parameters of this rank, set to the JAX initial values
    (global arrays by parameter name, each cut to the rank's shard)."""
    from repro_torch.models.model import init_lm
    from repro_torch.parallel import sharding

    params = init_lm(cfg, rcfg, pctx, torch.Generator().manual_seed(0),
                     device="cpu")
    specs = sharding.lm_param_specs(params, pctx)
    with torch.no_grad():
        for (name, p), sp in zip(params.named_parameters(), specs):
            p.copy_(sharding.cut(torch.from_numpy(init[name]), sp.dims))
    return params


def _factor_inputs():
    """Parameters and three steps' gradients of FACTOR_SHAPES (fp32)."""
    rng = np.random.default_rng(5)
    ps = [rng.standard_normal(s).astype(np.float32) for s in FACTOR_SHAPES]
    gs = [[(rng.standard_normal(s) * 10.0 ** rng.integers(-3, 2, s[:1])
            .reshape((-1,) + (1,) * (len(s) - 1))).astype(np.float32)
           for s in FACTOR_SHAPES] for _ in range(3)]
    return ps, gs


def _split_adafactor(g):
    """This EP rank's rows of FACTOR_SHAPES after three Adafactor steps
    over ``g``; returns the parameters, v_row and v_col."""
    from repro_torch.optim import adafactor

    from repro_torch.parallel.sharding import Placement

    R, r = g.size, g.rank
    ps, gs = _factor_inputs()
    rows = [torch.from_numpy(p[r * (p.shape[0] // R):][:p.shape[0] // R])
            .contiguous() for p in ps]
    split = [Placement(("model",) + (None,) * (p.dim() - 1),
                       (g,) + (None,) * (p.dim() - 1), g, None, None)
             for p in rows]
    opt = adafactor(1e-2)
    st = opt.init(rows)
    for i, gi in enumerate(gs):
        mine = [torch.from_numpy(x[r * (x.shape[0] // R):][:x.shape[0] // R])
                .contiguous() for x in gi]
        opt.update(mine, st, rows, i, placements=split)
    out = {}
    for i, p in enumerate(rows):
        out[f"factor/p{i}"] = p.numpy()
        out[f"factor/vr{i}"] = st.v_row[i].numpy()
        out[f"factor/vc{i}"] = st.v_col[i].numpy()
    return out


def _collectives_backward(g):
    """all_gather, all_reduce and shard under a gradient on ``g``; returns
    their forward values and the inputs' gradients."""
    from repro_torch.parallel import collectives

    R, r = g.size, g.rank
    w = torch.arange(R * 3, dtype=torch.float64).reshape(R, 3) + 1
    x = torch.full((3,), float(r + 1), dtype=torch.float64,
                   requires_grad=True)
    y = collectives.all_gather(g, x)
    (y * w).sum().backward()
    x2 = x.detach().clone().requires_grad_(True)
    z = collectives.all_reduce(g, x2)
    (z * w[0]).sum().backward()
    xr = torch.ones(2 * R, 3, dtype=torch.float64, requires_grad=True)
    sl = collectives.shard(g, xr, 0)
    (sl * (r + 1)).sum().backward()
    return {"gather/y": y.detach().numpy(), "gather/dx": x.grad.numpy(),
            "reduce/z": z.detach().numpy(), "reduce/dx": x2.grad.numpy(),
            "shard/x": sl.detach().numpy(), "shard/dx": xr.grad.numpy()}


def _masking(opt, params, specs, pctx, out, name):
    """``opt`` whose update also records, per parameter, where every
    step's gradient exceeds 1e-3 of the tensor's max|g| (at global
    shapes): Adam's update elsewhere is about lr sign(g) with a sign that
    rounding may decide."""
    from repro_torch.optim.optimizer import Optimizer
    from repro_torch.parallel import sharding

    names = [n for n, _ in params.named_parameters()]

    def update(grads, state, plist, step, **kw):
        for n, g, sp in zip(names, grads, specs):
            g = sharding.gather_whole(g, sp.dims)
            m = (g.abs() > 1e-3 * g.abs().max()).numpy()
            key = f"{name}/mask/{n}"
            out[key] = m if key not in out else out[key] & m
        return opt.update(grads, state, plist, step, **kw)

    return Optimizer(init=opt.init, update=update)


def _worker(rank, world, port, inputs, out_dir):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import (make_rack_mesh, make_test_mesh,
                                         pctx_for_mesh)
    from repro_torch.moe.layer import MoEParams
    from repro_torch.optim import adafactor, adamw
    from repro_torch.optim import optimizer as opt_mod
    from repro_torch.parallel import collectives, sharding
    from repro_torch.train.loop import (TrainConfig, global_grads,
                                        init_train_state, make_train_step,
                                        state_to_global)

    collectives.init("gloo", world_size=world, rank=rank,
                     init_method=f"tcp://localhost:{port}", timeout_s=120)
    data = np.load(inputs)
    init = {k[5:]: data[k] for k in data.files if k.startswith("init/")}
    batch = {k: torch.from_numpy(data[k]).to(torch.int64)
             for k in ("tokens", "targets")}
    meshes = {"flat": make_test_mesh(2, 4), "rack": make_rack_mesh(1, 2, 2)}
    out = _collectives_backward(meshes["flat"].model)
    out.update(_split_adafactor(meshes["flat"].model))

    # Each rank's own drops, read from the layer's stats.
    rec = []
    orig = MoEParams.forward

    def forward(self, x, cfg, **kw):
        y, aux, st = orig(self, x, cfg, **kw)
        rec.append(int(st.drops_dispatch + st.drops_slot))
        return y, aux, st

    MoEParams.forward = forward
    optimizers = {"adamw": adamw, "adafactor": adafactor}
    for name, (mesh_name, cf, use_bias, aux, opt_name, rows) in \
            CASES.items():
        mesh = meshes[mesh_name]
        if mesh is None:
            continue
        pctx = pctx_for_mesh(mesh)
        cfg, rcfg = _cfgs(cf, use_bias, aux)
        params = _params(cfg, rcfg, pctx, init)
        specs = sharding.lm_param_specs(params, pctx)
        opt = _masking(optimizers[opt_name](LR), params, specs, pctx, out,
                       name)
        state = init_train_state(params, opt, cfg)
        step = make_train_step(cfg, rcfg, pctx, opt, TrainConfig())
        for i in range(STEPS):
            rec.clear()
            state, m = step(state, {k: v[:rows] for k, v in batch.items()})
            pre = f"{name}/{i}/"
            out[pre + "loss"] = float(m["loss"])
            out[pre + "grad_norm"] = float(m["grad_norm"])
            out[pre + "drops"] = int(m["drops"])
            out[pre + "counts"] = m["counts"].numpy()
            out[pre + "rank_drops"] = sum(rec)
            if state.router_bias is not None:
                out[pre + "router_bias"] = state.router_bias.numpy()
        for k, v in state_to_global(state, pctx).items():
            if k.startswith("params/"):
                out[f"{name}/final/{k[7:]}"] = v.detach().numpy()
    MoEParams.forward = orig

    # The gradients of the global loss with the aux loss off.
    pctx = pctx_for_mesh(meshes["flat"])
    cfg, rcfg = _cfgs(8.0, False, 0.0)
    params = _params(cfg, rcfg, pctx, init)
    params.requires_grad_(True)
    _, _, _, grads = global_grads(params, batch, cfg, rcfg, pctx)
    specs = sharding.lm_param_specs(params, pctx)
    for (n, _), g, sp in zip(params.named_parameters(), grads, specs):
        out[f"aux0/grad/{n}"] = sharding.gather_whole(g, sp.dims).numpy()

    # The gradients' sums over the 8 ranks, in pieces of a few bytes.
    world_g = meshes["flat"].world
    opt_mod.BUCKET_BYTES = 24
    summed = [torch.full((7, 3), float(rank))]
    opt_mod.reduce_grads(summed, [world_g])
    out["reduce_grads"] = summed[0].numpy()
    np.savez(os.path.join(out_dir, f"torch_rank{rank}.npz"), **out)
    collectives.destroy()


def _spawn(inputs, out_dir):
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_worker, args=(WORLD, port, inputs, out_dir), nprocs=WORLD,
             join=True)


_JAX = r"""
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.core.balancer import BalancerConfig
from repro.launch.mesh import make_rack_mesh, make_test_mesh, pctx_for_mesh
from repro.models import transformer as jtr
from repro.models.model import init_lm
from repro.models.transformer import RuntimeConfig
from repro.optim import adafactor, adamw
from repro.train.loop import TrainConfig, init_train_state, make_train_step
from repro_torch import convert
from repro_torch.configs import get_config as t_get_config

cases, STEPS, B, S = {cases!r}, {steps}, {B}, {S}
REC = []
_orig = jtr.moe_layer_local


def recording(x, params, mcfg, *, axis_name=None, **kw):
    y, aux, st = _orig(x, params, mcfg, axis_name=axis_name, **kw)
    if axis_name is not None:
        axes = axis_name if isinstance(axis_name, tuple) else (axis_name,)
        idx = [jax.lax.axis_index(a) for a in ("data",) + axes]
        jax.debug.callback(lambda *a: REC.append(tuple(int(v) for v in a)),
                           *idx, st.drops_dispatch + st.drops_slot)
    return y, aux, st


jtr.moe_layer_local = recording
base = get_config("tiny-moe")
tokens = jax.random.randint(jax.random.PRNGKey(1), (B, S), 0, base.vocab_size)
targets = jax.random.randint(jax.random.PRNGKey(2), (B, S), 0,
                             base.vocab_size)
batch = {{"tokens": tokens, "targets": targets}}
out = {{"tokens": np.asarray(tokens), "targets": np.asarray(targets)}}


def port_named(params, cfg):
    tp = convert.lm_params(jax.tree.map(np.asarray, params), cfg,
                           device="cpu")
    return {{n: p.detach().numpy() for n, p in tp.named_parameters()}}


meshes = {{"flat": make_test_mesh(2, 4), "rack": make_rack_mesh(1, 2, 2)}}
for name, (mesh_name, cf, use_bias, aux, opt_name, rows) in cases.items():
    mesh = meshes[mesh_name]
    pctx = pctx_for_mesh(mesh)
    moe = {{"use_bias": use_bias}}
    if aux is not None:
        moe["aux_loss_weight"] = aux
    cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, **moe))
    tcfg = dataclasses.replace(t_get_config("tiny-moe"),
                               moe=dataclasses.replace(
                                   t_get_config("tiny-moe").moe, **moe))
    rcfg = RuntimeConfig(balancer=BalancerConfig(mode="ultraep", n_slot=2),
                         cf_pair=cf, cf_slot=cf, remat=False,
                         scan_layers=opt_name == "adamw")
    params = init_lm(jax.random.PRNGKey(0), cfg, rcfg, pctx)
    if "init/embedding" not in out:
        for n, a in port_named(params, tcfg).items():
            out["init/" + n] = a
    opt = {{"adamw": adamw, "adafactor": adafactor}}[opt_name](1e-3)
    state = init_train_state(params, opt, cfg)
    step = jax.jit(make_train_step(cfg, rcfg, pctx, opt, TrainConfig()))
    shape = tuple(mesh.shape.values())
    for i in range(STEPS):
        REC.clear()
        state, m = step(state, {{k: v[:rows] for k, v in batch.items()}})
        jax.block_until_ready(m["loss"])
        pre = f"{{name}}/{{i}}/"
        for k in ("loss", "grad_norm", "drops", "counts"):
            out[pre + k] = np.asarray(m[k])
        if state.router_bias is not None:
            out[pre + "router_bias"] = np.asarray(state.router_bias)
        per = np.zeros(shape, np.int64)
        for *ix, d in REC:
            per[tuple(ix)] += d
        out[pre + "rank_drops"] = per.reshape(-1)
    for n, a in port_named(state.params, tcfg).items():
        out[f"{{name}}/final/{{n}}"] = a
np.savez({result!r}, **out)
print("DONE")
"""


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """The JAX run, then the torch run on its inputs; returns (JAX
    results, each torch rank's results)."""
    from tests.helpers import run_multidevice

    tmp = tmp_path_factory.mktemp("train_ep")
    jax_out = str(tmp / "jax.npz")
    code = _JAX.format(cases=CASES, steps=STEPS, B=B, S=S, result=jax_out)
    assert "DONE" in run_multidevice(code, WORLD, 400)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", f"from tests.test_torch_train_ep import "
         f"_spawn; _spawn({jax_out!r}, {str(tmp)!r})"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ranks = [dict(np.load(tmp / f"torch_rank{r}.npz")) for r in range(WORLD)]
    return dict(np.load(jax_out)), ranks


def _ranks_of(name, ranks):
    return ranks[:4] if CASES[name][0] == "rack" else ranks


def _close(got, want, what):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("step", range(STEPS))
def test_mesh_step_metrics_match_jax(mesh_run, name, step):
    jax_out, ranks = mesh_run
    pre = f"{name}/{step}/"
    mine = _ranks_of(name, ranks)
    for r in mine:
        _close(r[pre + "loss"], jax_out[pre + "loss"], "loss")
        _close(r[pre + "grad_norm"], jax_out[pre + "grad_norm"], "grad_norm")
        assert int(r[pre + "drops"]) == int(jax_out[pre + "drops"])
        np.testing.assert_array_equal(r[pre + "counts"],
                                      jax_out[pre + "counts"])
        if pre + "router_bias" in jax_out:
            _close(r[pre + "router_bias"], jax_out[pre + "router_bias"],
                   "router_bias")
    np.testing.assert_array_equal(
        np.array([int(r[pre + "rank_drops"]) for r in mine]),
        jax_out[pre + "rank_drops"])
    if name == "tight":
        assert (jax_out[pre + "rank_drops"] > 0).all()
    elif CASES[name][1] < 8:         # the capacity floor binds
        assert int(jax_out[pre + "drops"]) > 0
    else:
        assert int(jax_out[pre + "drops"]) == 0


def test_mesh_step_zero_loss_is_the_reference_snippet(mesh_run):
    """The reference's full-model mesh test's first loss (its batch, its
    parameters)."""
    jax_out, ranks = mesh_run
    assert abs(float(jax_out["d2e4/0/loss"]) - 5.0352) < 1e-4
    assert abs(float(ranks[0]["d2e4/0/loss"]) - 5.0352) < 1e-4


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_params_after_steps_match_jax(mesh_run, name):
    """Every parameter within 1e-5 of its max|p| where each step's gradient
    exceeded 1e-3 of its max|g| (as tests/test_torch_train.py compares
    updated parameters); elsewhere Adam moves an element by about lr a
    step in a direction rounding may decide, so there within that (and
    Adafactor, whose clipped update there is about lr a step or less).
    A case on fewer rows than B leaves the embedding rows that none of
    its tokens selects without a gradient, so there the share of compared
    elements counts the selected rows."""
    jax_out, ranks = mesh_run
    keys = [k for k in jax_out if k.startswith(f"{name}/final/")]
    rows = CASES[name][5]
    assert keys
    for k in keys:
        want = jax_out[k]
        reach = np.ones(want.shape, bool)
        if rows < B and k.endswith("/embedding"):
            reach = np.zeros(want.shape, bool)
            reach[np.unique(jax_out["tokens"][:rows])] = True
        for r in _ranks_of(name, ranks)[::3]:
            mask = r[k.replace("/final/", "/mask/")]
            assert mask[reach].mean() > 0.8, (k, mask[reach].mean())
            err = np.abs(r[k] - want)
            assert (err[mask] <= TOL * np.abs(want).max()).all(), \
                (k, err[mask].max(), np.abs(want).max())
            assert (err <= 2 * LR * STEPS).all(), (k, err.max())
        assert not np.array_equal(want, jax_out["init/" + k.split("/", 2)[2]])


def test_mesh_gradients_equal_single_rank_without_aux(mesh_run):
    from repro_torch.models.transformer import ParallelCtx
    from repro_torch.train.loop import loss_and_grads

    jax_out, ranks = mesh_run
    init = {k[5:]: jax_out[k] for k in jax_out if k.startswith("init/")}
    cfg, rcfg = _cfgs(8.0, False, 0.0)
    params = _params(cfg, rcfg, ParallelCtx(), init)
    params.requires_grad_(True)
    batch = {k: torch.from_numpy(jax_out[k]).to(torch.int64)
             for k in ("tokens", "targets")}
    _, _, _, grads = loss_and_grads(params, batch, cfg, rcfg, ParallelCtx())
    for (n, _), g in zip(params.named_parameters(), grads):
        for r in ranks:
            _close(r[f"aux0/grad/{n}"], g.numpy(), n)


def test_reduce_grads_in_pieces_sums_over_the_world(mesh_run):
    _, ranks = mesh_run
    for r in ranks:
        np.testing.assert_array_equal(r["reduce_grads"],
                                      np.full((7, 3), 28.0))


def test_collectives_backward_at_four_ranks(mesh_run):
    _, ranks = mesh_run
    w = np.arange(12, dtype=np.float64).reshape(4, 3) + 1
    for i, r in enumerate(ranks):
        e = i % 4            # the EP rank of global rank d * 4 + e
        np.testing.assert_array_equal(r["gather/y"],
                                      np.repeat(np.arange(1, 5.0)[:, None],
                                                3, 1))
        np.testing.assert_array_equal(r["gather/dx"], w[e])
        np.testing.assert_array_equal(r["reduce/z"], np.full(3, 10.0))
        np.testing.assert_array_equal(r["reduce/dx"], w[0])
        np.testing.assert_array_equal(r["shard/x"], np.ones((2, 3)))
        np.testing.assert_array_equal(
            r["shard/dx"], np.repeat(np.arange(1, 5.0), 2)[:, None]
            .repeat(3, 1))


def test_ep_split_adafactor_matches_jax_whole(mesh_run):
    import jax.numpy as jnp
    from repro.optim import adafactor as jax_adafactor

    _, ranks = mesh_run
    ps, gs = _factor_inputs()
    opt = jax_adafactor(1e-2)
    jp = [jnp.asarray(p) for p in ps]
    st = opt.init(jp)
    for i, gi in enumerate(gs):
        upd, st = opt.update([jnp.asarray(x) for x in gi], st, jp, i)
        jp = [p + u for p, u in zip(jp, upd)]
    for i, shape in enumerate(FACTOR_SHAPES):
        p, vr, vc = (np.asarray(a[i]) for a in (jp, st.v_row, st.v_col))
        n = shape[0] // 4
        for j, r in enumerate(ranks):
            e = j % 4
            _close(r[f"factor/p{i}"], p[e * n:(e + 1) * n], f"p{i}")
            _close(r[f"factor/vr{i}"], vr[e * n:(e + 1) * n], f"vr{i}")
            want_vc = vc[e * n:(e + 1) * n] if len(shape) >= 3 else vc
            _close(r[f"factor/vc{i}"], want_vc, f"vc{i}")
