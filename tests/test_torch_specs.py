"""The train cells (``launch/specs.py``) and an Adafactor train step of the
port against the JAX package's, on the CPU.

* ``supported_shapes``, ``runtime_for`` and the optimizer a train cell
  picks, for every arch the port registers, as JAX's ``repro.launch.
  specs``;
* the parameter and optimizer-state shapes of ``build_cell(arch,
  "train_4k", ..., num_layers_override=2)`` (meta tensors, nothing
  allocated) as JAX's ``jax.eval_shape``, at every published width, and
  the prefill and decode cells' parameter, cache and batch shapes.  The
  port keeps each layer's tensors apart, so the JAX cell is built with
  ``scan_layers=False`` (each layer's leaves apart too): a scanned segment
  stacks its layers, and Adafactor then factors a stacked norm (L, D),
  which a per-layer (D,) norm is not;
* one ``make_train_step`` with Adafactor (the cells' lr 1e-4) on reduced
  two-layer DeepSeek-V3 (MLA, dense + MoE, the aux-free bias) and
  Jamba-v0.1 (Mamba + dense, Mamba + MoE), remat
  on in both, fp32: the loss, every gradient, v_row and v_col within 1e-4
  of each tensor's max|ref|, counts equal, and the updated parameters
  within 1e-4 where |g| exceeds 1e-3 of its tensor's max|g| (Adafactor's
  first step is about lr g / |g|, decided by rounding where g is tiny).
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
from repro.launch import specs as jspecs
from repro.models import model as jmodel
from repro.models.transformer import ParallelCtx as JParallelCtx
from repro.models.transformer import RuntimeConfig as JRuntimeConfig
from repro.optim import optimizer as jopt
from repro.train import loop as jloop
from repro_torch import convert
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.reduce import reduced
from repro_torch.core.balancer import BalancerConfig
from repro_torch.launch import specs
from repro_torch.models.transformer import ParallelCtx, RuntimeConfig
from repro_torch.optim import optimizer as topt
from repro_torch.train import loop as tloop

TOL = 1e-4
BIG_ARCHS = ["deepseek-v3-671b", "jamba-v0.1-52b", "glm45-106b-a12b",
             "qwen3-235b-a22b"]


def test_shapes_table_is_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jspecs.SHAPES.items()}


@pytest.mark.parametrize("arch", list_archs())
def test_supported_shapes_runtime_and_optimizer_match_jax(arch):
    """Every registered arch: its supported shapes, and for each the
    runtime's balancer, dtype, key block and remat, as JAX's; a train
    cell's optimizer Adafactor exactly for JAX's big archs."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert specs.supported_shapes(cfg) == jspecs.supported_shapes(jcfg)
    for name in specs.supported_shapes(cfg):
        for analysis in (False, True):
            r = specs.runtime_for(cfg, SHAPES[name], analysis=analysis)
            j = jspecs.runtime_for(jcfg, jspecs.SHAPES[name],
                                   analysis=analysis)
            assert dataclasses.asdict(r.balancer) == \
                dataclasses.asdict(j.balancer)
            assert (r.block_kv, r.remat) == (j.block_kv, j.remat)
            assert r.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
    assert (arch in specs._BIG) == (arch in jspecs._BIG)


def _shape_list(leaves):
    return sorted(tuple(int(d) for d in np.shape(x)) for x in leaves)


@pytest.mark.parametrize("arch", BIG_ARCHS + ["tiny-moe", "tiny-hybrid"])
def test_train_cell_shapes_match_jax_eval_shape(arch):
    """``build_cell(arch, "train_4k", ParallelCtx(),
    num_layers_override=2)``: meta tensors only; its parameters and
    optimizer state (type and every tensor's shape) as JAX's abstract
    cell's, whose layers are kept apart (``scan_layers=False``)."""
    cell = specs.build_cell(arch, "train_4k", ParallelCtx(),
                            num_layers_override=2)
    jcell = jspecs.build_cell(arch, "train_4k", JParallelCtx(),
                              num_layers_override=2,
                              rcfg_overrides={"scan_layers": False})
    state, batch = cell.arg_shapes
    jstate, jbatch = jcell.arg_shapes
    params = list(state.params.parameters())
    assert all(p.device.type == "meta" for p in params)
    assert _shape_list(params) == _shape_list(jax.tree.leaves(jstate.params))
    assert type(state.opt_state).__name__ == type(jstate.opt_state).__name__
    for field in jstate.opt_state._fields:
        assert _shape_list(getattr(state.opt_state, field)) == \
            _shape_list(jax.tree.leaves(getattr(jstate.opt_state, field))), \
            field
    assert {k: tuple(v.shape) for k, v in batch.items()} == \
        {k: tuple(v.shape) for k, v in jbatch.items()}
    assert cell.in_shardings is None and cell.donate == jcell.donate
    assert cell.meta["rcfg"].remat and cell.meta["shape"].kind == "train"


@pytest.mark.parametrize("arch,shape", [("jamba-v0.1-52b", "decode_32k"),
                                        ("glm45-106b-a12b", "decode_32k"),
                                        ("deepseek-v3-671b", "prefill_32k")])
def test_serve_cell_shapes_match_jax_eval_shape(arch, shape):
    """The prefill and decode cells: parameters, decode caches (KV or SSM
    state, one entry a layer) and batch shapes as JAX's abstract cell's
    (``scan_layers=False``), the same donated argument."""
    cell = specs.build_cell(arch, shape, ParallelCtx(),
                            num_layers_override=2)
    jcell = jspecs.build_cell(arch, shape, JParallelCtx(),
                              num_layers_override=2,
                              rcfg_overrides={"scan_layers": False})
    assert len(cell.arg_shapes) == len(jcell.arg_shapes)
    assert cell.donate == jcell.donate
    assert _shape_list(cell.arg_shapes[0].parameters()) == \
        _shape_list(jax.tree.leaves(jcell.arg_shapes[0]))
    if len(cell.arg_shapes) == 3:
        assert _shape_list(t for c in cell.arg_shapes[1] for t in c) == \
            _shape_list(jax.tree.leaves(jcell.arg_shapes[1]))
    assert {k: tuple(v.shape) for k, v in cell.arg_shapes[-1].items()} == \
        {k: tuple(v.shape) for k, v in jcell.arg_shapes[-1].items()}


def _names_by_jax_leaf(jparams, tcfg):
    """The port's parameter name of each JAX leaf (in ``jax.tree.leaves``
    order): each leaf carried across filled with its own index."""
    leaves, treedef = jax.tree.flatten(jparams)
    ids = treedef.unflatten([np.full(np.shape(x), k, np.float32)
                             for k, x in enumerate(leaves)])
    mod = convert.lm_params(ids, tcfg, device="cpu")
    names = {int(p.reshape(-1)[0]): n for n, p in mod.named_parameters()}
    return [names[k] for k in range(len(leaves))]


def _close(t, j, name, tol=TOL):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    scale = max(np.abs(j).max(), 1e-30)
    err = np.abs(t - j).max()
    assert err <= tol * scale, f"{name}: max|err| {err:.3e} > {tol} * {scale:.3e}"


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "jamba-v0.1-52b"])
def test_adafactor_train_step_matches_jax(arch):
    jcfg = j_reduced(j_get_config(arch), layers=2)
    tcfg = reduced(get_config(arch), layers=2)
    jrcfg = JRuntimeConfig(balancer=JBalancerConfig(mode="ultraep", n_slot=2),
                           cf_pair=4.0, cf_slot=4.0, scan_layers=False,
                           remat=True)
    trcfg = RuntimeConfig(balancer=BalancerConfig(mode="ultraep", n_slot=2),
                          cf_pair=4.0, cf_slot=4.0, remat=True)
    jparams = jmodel.init_lm(jax.random.PRNGKey(0), jcfg, jrcfg,
                             JParallelCtx(mesh=None))
    names = _names_by_jax_leaf(jparams, tcfg)
    tparams = convert.lm_params(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    jo, to = jopt.adafactor(1e-4), topt.adafactor(1e-4)
    jstate = jloop.init_train_state(jparams, jo, jcfg)
    tstate = tloop.init_train_state(tparams, to, tcfg)
    rng = np.random.default_rng(0)
    tok = rng.integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    tgt = rng.integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tok), "targets": jnp.asarray(tgt)}
    tb = {"tokens": torch.from_numpy(tok).long(),
          "targets": torch.from_numpy(tgt).long()}

    def loss_fn(params):
        logits, aux, _, _ = jmodel.forward(params, jb, jcfg, jrcfg,
                                           JParallelCtx(mesh=None),
                                           router_bias=jstate.router_bias)
        return jmodel.lm_loss(logits, jb["targets"]) + aux

    jgrads = jax.tree.leaves(jax.jit(jax.grad(loss_fn))(jstate.params))
    tnamed = dict(tstate.params.named_parameters())
    _, _, _, tgrads = tloop.loss_and_grads(
        tstate.params, tb, tcfg, trcfg, ParallelCtx(),
        router_bias=tstate.router_bias)
    tg = {n: g.clone() for n, g in zip(tnamed, tgrads)}
    for n, jg in zip(names, jgrads):
        _close(tg[n], jg, f"grad {n}")

    jstep = jax.jit(jloop.make_train_step(jcfg, jrcfg, JParallelCtx(mesh=None),
                                          jo))
    tstep = tloop.make_train_step(tcfg, trcfg, ParallelCtx(), to)
    jstate, jm = jstep(jstate, jb)
    tstate, tm = tstep(tstate, tb)
    _close(tm["loss"], jm["loss"], "loss")
    np.testing.assert_array_equal(tm["counts"].numpy(),
                                  np.asarray(jm["counts"]))
    order = [n for n, _ in tstate.params.named_parameters()]
    for field in ("v_row", "v_col"):
        mine = dict(zip(order, getattr(tstate.opt_state, field)))
        for n, jv in zip(names, jax.tree.leaves(getattr(jstate.opt_state,
                                                        field))):
            _close(mine[n], jv, f"{field} {n}")
    new = dict(tstate.params.named_parameters())
    for n, jp, jg in zip(names, jax.tree.leaves(jstate.params), jgrads):
        g = np.abs(np.asarray(jg))
        sure = g > 1e-3 * g.max()
        _close(new[n].detach().numpy()[sure], np.asarray(jp)[sure],
               f"param {n}")


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_serve_cell_steps_run(shape, monkeypatch):
    """A serve cell's step runs on real parameters of the cell's model (a
    reduced DeepSeek-V3 here, on the CPU): logits of the batch's shape,
    finite."""
    from repro_torch.models.model import init_caches, init_lm

    full = specs.get_config
    monkeypatch.setattr(specs, "get_config", lambda a: reduced(full(a)))
    cell = specs.build_cell("deepseek-v3-671b", shape, ParallelCtx())
    cfg, rcfg = cell.meta["cfg"], cell.meta["rcfg"]
    params = init_lm(cfg, rcfg, ParallelCtx(), torch.Generator().manual_seed(0),
                     device="cpu")
    if shape == "prefill_32k":
        logits = cell.step_fn(params, {"tokens": torch.zeros(
            (2, 64), dtype=torch.int64)})[0]
        assert logits.shape == (2, 64, cfg.vocab_size)
    else:
        caches = init_caches(cfg, 2, 64, rcfg, device="cpu")
        logits = cell.step_fn(params, caches, {"tokens": torch.zeros(
            (2, 1), dtype=torch.int64)})[0]
        assert logits.shape == (2, 1, cfg.vocab_size)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("flag", [["--seq", "256"], ["--lr", "1e-2"],
                                  ["--dtype", "bfloat16"], ["--reduce"],
                                  ["--balancer", "eplb"],
                                  ["--d-model", "32"]])
def test_train_cli_refuses_flags_a_cell_fixes(flag, capsys):
    """``--cell`` with a flag whose value the cell fixes stops before
    anything is built, naming the flag."""
    from repro_torch.launch.train import main

    with pytest.raises(SystemExit) as e:
        main(["--arch", "tiny-moe", "--cell", "train_4k", "--device", "cpu",
              *flag])
    assert e.value.code == 2
    assert f"--cell fixes {flag[0]}" in capsys.readouterr().err
