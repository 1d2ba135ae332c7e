"""The reference's layout on a mesh (``repro_torch.parallel.sharding``,
``ParallelCtx.shard_dense``) against the JAX package's.

* Placements: for every registered config at full width, on the 16 x 16
  pod, the 2 x 16 x 16 multi-pod and a (data 16, rack 2, model 8) rack
  mesh, each parameter's entries equal the reference's ``lm_param_specs``
  (``scan_layers=False``, one entry per layer), dimension by dimension,
  the batch axes one entry; so do ``batch_specs`` (train, prefill and
  decode), ``opt_state_specs`` (AdamW and Adafactor) and
  ``activation_spec``.  The reference reads only ``pctx.mesh.shape``, so
  a stand-in with that dict takes the mesh's place and no device is
  needed.  A shard's shape (``shard_shape``) divides each placed
  dimension by its axes' sizes.
* Computation: one run of four gloo processes on a (data 2, model 2)
  mesh (``torch.multiprocessing``, spawn) beside JAX on the same mesh of
  four virtual CPU devices, one process a config, all started at once:
  both sides start from the port's one-rank init (the ranks' sharded
  init cuts it; the JAX run puts its values into the reference's tree)
  and one numpy batch.  Two configs: ``gqa``, ``tiny-moe`` with a
  dense first layer and a shared expert (the vocabulary 128 divides by
  2), and ``mla``, ``tiny-mla-moe`` (q_lora and kv_lora 16).  The loss
  and every gradient (gathered) of one global batch (B 4, S 16), the
  parameters after two AdamW and after two Adafactor steps on it (within
  ``TOL`` of their max|p| where each step's gradient exceeded 1e-3 of
  its max|g|, as ``tests/test_torch_train_ep.py`` compares them), and the
  logits of two prefill chunks (B 2, C 8) gathered over both axes,
  within ``TOL`` of each tensor's max|ref|.
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
TOL = 1e-5               # tests/test_torch_train_ep.py's
LR, STEPS, B, S = 1e-3, 2, 4, 16
PB, PC = 2, 8            # prefill rows and chunk length (two chunks)
# name: (registered config, ModelConfig overrides, MoEArch overrides)
CONFIGS = {
    "gqa": ("tiny-moe", {"d_ff": 64},
            {"first_dense_layers": 1, "n_shared_experts": 1,
             "shared_d_ff": 32}),
    "mla": ("tiny-mla-moe", {}, {}),
}
MESHES = {"pod": {"data": 16, "model": 16},
          "multi_pod": {"pod": 2, "data": 16, "model": 16},
          "rack": {"data": 16, "rack": 2, "model": 8}}


def _archs():
    from repro_torch.configs import list_archs

    return list_archs()


class _StandInMesh:
    """What the reference's ``from_ctx`` reads of a mesh: its shape."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _jax_pctx(shape):
    from repro.models.transformer import ParallelCtx

    batch = tuple(a for a in shape if a not in ("model", "rack"))
    return ParallelCtx(mesh=_StandInMesh(shape), batch_axes=batch,
                       model_axis="model",
                       rack_axis="rack" if "rack" in shape else None)


def _entry(e):
    """A placement entry with a one-axis tuple taken as that axis (as a
    PartitionSpec stores it)."""
    return e[0] if isinstance(e, tuple) and len(e) == 1 else e


def _entries(spec):
    return None if spec is None else tuple(_entry(e) for e in spec)


def _norm(layout: dict) -> dict:
    return {k: _entries(v) for k, v in layout.items()}


def _reference_layout(cfg, pctx) -> dict:
    """The reference's ``lm_param_specs`` keyed by the port's parameter
    names (``scan_layers=False``: each segment a tuple of layers)."""
    from repro.models.transformer import RuntimeConfig
    from repro.parallel import sharding as jsh

    tree = jsh.lm_param_specs(cfg, RuntimeConfig(scan_layers=False), pctx)
    out = {"embedding": _entries(tree.embedding)}
    layers = [bs for seg in tree.segments for bs in seg]
    for i, bs in enumerate(layers):
        pre = f"layers.{i}."
        out[pre + "norm1"] = _entries(bs.norm1)
        if bs.norm2 is not None:
            out[pre + "norm2"] = _entries(bs.norm2)
        for field in ("attn", "ssm", "moe"):
            sub = getattr(bs, field)
            if sub is None:
                continue
            for k, v in sub._asdict().items():
                if v is not None:
                    out[f"{pre}{field}.{k}"] = _entries(v)
        if bs.ffn is not None:
            for j, v in enumerate(bs.ffn):
                out[f"{pre}ffn.{j}"] = _entries(v)
    out["final_norm"] = _entries(tree.final_norm)
    if tree.lm_head is not None:
        out["lm_head"] = _entries(tree.lm_head)
    if tree.frontend_proj is not None:
        out["frontend_proj"] = _entries(tree.frontend_proj)
    return out


@pytest.mark.parametrize("arch", _archs())
def test_param_placements_equal_the_reference(arch):
    """Every parameter's entries on the three production meshes, and the
    names as the port's own parameters (a meta init at full width)."""
    from repro.configs import get_config as j_get_config
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_lm
    from repro_torch.models.transformer import ParallelCtx, RuntimeConfig
    from repro_torch.parallel import sharding

    cfg, jcfg = get_config(arch), j_get_config(arch)
    names = [n for n, _ in init_lm(cfg, RuntimeConfig(), ParallelCtx(),
                                   None, device="meta").named_parameters()]
    for shape in MESHES.values():
        mine = sharding.param_layout(cfg, sharding.mesh_axes(shape))
        assert sorted(mine) == sorted(names)
        assert _norm(mine) == _reference_layout(jcfg, _jax_pctx(shape)), \
            shape


@pytest.mark.parametrize("arch", _archs())
def test_batch_opt_and_activation_specs_equal_the_reference(arch):
    """``batch_specs`` at each shape's global batch (and one that does not
    divide), ``opt_state_specs`` of AdamW and Adafactor, and
    ``activation_spec``, on the three production meshes."""
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config as j_get_config
    from repro.optim.optimizer import AdafactorState, AdamWState
    from repro.parallel import sharding as jsh
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.parallel import sharding

    cfg, jcfg = get_config(arch), j_get_config(arch)
    for shape in MESHES.values():
        ax, jp = sharding.mesh_axes(shape), _jax_pctx(shape)
        for kind in ("train", "prefill", "decode"):
            for gb in {s.global_batch for s in SHAPES.values()} | {3}:
                want = {k: _entries(v) for k, v in
                        jsh.batch_specs(jcfg, jp, kind, gb).items()}
                assert _norm(sharding.batch_specs(cfg, ax, kind, gb)) == want
            assert _entries(sharding.activation_spec(ax, kind)) == \
                _entries(jsh.activation_spec(jp, kind))
        layout = sharding.param_layout(cfg, ax)
        ref = _reference_layout(jcfg, jp)
        adam = sharding.opt_state_specs(layout, "adamw")
        assert _norm(adam["mu"]) == ref and _norm(adam["nu"]) == ref
        # The reference maps its specs' tree; its leaves stand in here for
        # one tree of every parameter's spec.
        names = list(ref)
        leaves = [P(*ref[n]) for n in names]
        fac = jsh.opt_state_specs(leaves, AdafactorState(None, None))
        got = sharding.opt_state_specs(layout, "adafactor")
        is_p = lambda x: isinstance(x, P)  # noqa: E731
        for field in ("v_row", "v_col"):
            want = jax.tree.leaves(getattr(fac, field), is_leaf=is_p)
            assert [_entries(got[field][n]) for n in names] == \
                [_entries(w) for w in want], field
        assert isinstance(jsh.opt_state_specs(leaves, AdamWState(None, None)),
                          AdamWState)


def test_shard_shapes_and_production_meshes():
    from repro_torch.launch.mesh import production_shape
    from repro_torch.parallel import sharding

    assert production_shape() == ((16, 16), ("data", "model"))
    assert production_shape(multi_pod=True) == (
        (2, 16, 16), ("pod", "data", "model"))
    assert production_shape(racks=4) == ((16, 4, 4),
                                         ("data", "rack", "model"))
    assert production_shape(multi_pod=True, racks=2)[1] == (
        "pod", "data", "rack", "model")
    with pytest.raises(ValueError, match="must divide the 16-way"):
        production_shape(racks=3)
    sizes = MESHES["multi_pod"]
    spec = (("pod", "data"), "model", None)
    assert sharding.shard_shape(spec, (64, 32, 5), sizes) == (2, 2, 5)
    assert sharding.shard_shape((("rack", "model"), None), (32, 7),
                                MESHES["rack"]) == (2, 7)


def test_decode_on_the_sharded_layout_raises():
    from repro_torch.configs import get_config
    from repro_torch.models.model import decode_step, init_caches, init_lm
    from repro_torch.models.transformer import ParallelCtx, RuntimeConfig

    cfg, rcfg = get_config("tiny-moe"), RuntimeConfig()
    params = init_lm(cfg, rcfg, ParallelCtx(),
                     torch.Generator().manual_seed(0), device="cpu")
    caches = init_caches(cfg, 1, 8, rcfg, device="cpu")
    with pytest.raises(ValueError, match="decode on the sharded layout"):
        decode_step(params, caches, torch.zeros((1, 1), dtype=torch.int64),
                    cfg, rcfg, ParallelCtx(shard_dense=True))


# ------------------------------------------------ the four-rank run ----

def _port_cfgs(name):
    from repro_torch.configs import get_config
    from repro_torch.core.balancer import BalancerConfig
    from repro_torch.models.transformer import RuntimeConfig

    arch, over, moe = CONFIGS[name]
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, **over,
                              moe=dataclasses.replace(cfg.moe, **moe))
    rcfg = RuntimeConfig(balancer=BalancerConfig(mode="ultraep", n_slot=2),
                         cf_pair=8.0, cf_slot=8.0)
    return cfg, rcfg


def _batch(cfg) -> dict:
    rng = np.random.default_rng(1)
    return {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64)
            for k in ("tokens", "targets")}


def _port_init(name) -> dict:
    """The port's one-rank initial parameters by name (numpy)."""
    from repro_torch.models.model import init_lm
    from repro_torch.models.transformer import ParallelCtx

    cfg, rcfg = _port_cfgs(name)
    params = init_lm(cfg, rcfg, ParallelCtx(),
                     torch.Generator().manual_seed(0), device="cpu")
    return {n: p.detach().numpy() for n, p in params.named_parameters()}


def _pairs_backward(g):
    """The sharded layout's collective pairs under a gradient on a group
    of 2: their forward values and the inputs' gradients."""
    from repro_torch.parallel import collectives

    r = g.rank
    w = torch.arange(12, dtype=torch.float64).reshape(3, 4) * (r + 1)
    x = torch.full((3, 2), float(r + 1), dtype=torch.float64,
                   requires_grad=True)
    y = collectives.gather_along(g, x, 1)            # (3, 4)
    (y * w).sum().backward()
    z = torch.ones(4, 3, dtype=torch.float64, requires_grad=True)
    s = collectives.scatter_along(g, z * (r + 1), 0)  # (2, 3)
    (s * (r + 1)).sum().backward()
    a = torch.ones(3, dtype=torch.float64, requires_grad=True)
    b = collectives.sum_grad(g, a)
    (b * (r + 1)).sum().backward()
    return {"pairs/y": y.detach().numpy(), "pairs/dx": x.grad.numpy(),
            "pairs/s": s.detach().numpy(), "pairs/dz": z.grad.numpy(),
            "pairs/b": b.detach().numpy(), "pairs/da": a.grad.numpy()}


def _init_is_slice(name, params, specs, pctx) -> bool:
    """The sharded init equals the one-rank init's slice bitwise, and so
    does ``convert.lm_params`` of the one-rank values on this mesh."""
    from types import SimpleNamespace

    from repro_torch import convert
    from repro_torch.parallel import sharding

    whole = _port_init(name)
    ok = all(torch.equal(p, sharding.cut(torch.from_numpy(whole[n]), sp.dims))
             for (n, p), sp in zip(params.named_parameters(), specs))
    cfg, _ = _port_cfgs(name)
    ns = SimpleNamespace
    a = lambda n: whole.get(n)  # noqa: E731
    blocks = []
    for i in range(cfg.num_layers):
        pre = f"layers.{i}."

        def sub(field, pre=pre):
            keys = {k[len(pre + field) + 1:]: v for k, v in whole.items()
                    if k.startswith(f"{pre}{field}.")}
            return ns(**keys) if keys else None

        moe, attn = sub("moe"), sub("attn")
        for t, keys in ((moe, ("shared_w1", "shared_w3", "shared_w2")),
                        (attn, ("bq", "bk", "bv", "q_norm", "k_norm"))):
            for k in keys if t is not None else ():
                setattr(t, k, getattr(t, k, None))
        ffn = (None if a(pre + "ffn.0") is None
               else tuple(a(f"{pre}ffn.{j}") for j in range(3)))
        blocks.append(ns(norm1=a(pre + "norm1"), norm2=a(pre + "norm2"),
                         attn=attn, ssm=None, ffn=ffn, moe=moe))
    tree = ns(embedding=a("embedding"), segments=(tuple(blocks),),
              final_norm=a("final_norm"), lm_head=a("lm_head"),
              frontend_proj=a("frontend_proj"))
    conv = convert.lm_params(tree, cfg, device="cpu", pctx=pctx)
    return ok and all(torch.equal(p, q) for p, q in
                      zip(params.parameters(), conv.parameters()))


def _restores(tree, cfg, rcfg, pctx, opt) -> bool:
    """A checkpoint's global tree restores onto this mesh (a fresh state
    gives the same tree back) and onto one rank (whole parameters)."""
    from repro_torch.models.model import init_lm
    from repro_torch.models.transformer import ParallelCtx
    from repro_torch.train.loop import (init_train_state, state_from_global,
                                        state_to_global)

    ok = True
    for ctx in (pctx, ParallelCtx()):
        params = init_lm(cfg, rcfg, ctx, torch.Generator().manual_seed(7),
                         device="cpu")
        state = state_from_global(init_train_state(params, opt, cfg, ctx),
                                  tree, ctx)
        back = state_to_global(state, ctx)
        ok = ok and all(torch.equal(torch.as_tensor(back[k]),
                                    torch.as_tensor(v))
                        for k, v in tree.items() if k != "step")
    return ok


def _cell_on_mesh(pctx) -> bool:
    """``build_cell`` on the mesh: ``in_shardings`` holds the placements
    in the reference's TrainState order, and ``arg_shapes`` are this
    rank's shards (parameters, AdamW moments, the batch)."""
    from repro_torch.launch.specs import build_cell
    from repro_torch.models.model import init_lm
    from repro_torch.models.transformer import ParallelCtx
    from repro_torch.parallel import sharding

    cell = build_cell("tiny-moe", "train_4k", pctx)
    (state_specs, bspecs), (state, batch) = cell.in_shardings, cell.arg_shapes
    cfg = cell.meta["cfg"]
    ax = sharding.from_ctx(pctx)
    layout = sharding.param_layout(cfg, ax)
    glob = {n: p.shape for n, p in init_lm(
        cfg, cell.meta["rcfg"], ParallelCtx(), None,
        device="meta").named_parameters()}
    shards = {n: sharding.shard_shape(layout[n], glob[n], ax.sizes)
              for n in glob}
    B, S = cell.meta["shape"].global_batch, cell.meta["shape"].seq_len
    return (state_specs.params == layout
            and state_specs.opt_state == sharding.opt_state_specs(layout,
                                                                  "adamw")
            and state_specs.step == () and bspecs == sharding.batch_specs(
                cfg, ax, "train", B)
            and all(tuple(p.shape) == shards[n]
                    for n, p in state.params.named_parameters())
            and all(tuple(m.shape) == tuple(v.shape) == shards[n]
                    for (n, _), m, v in zip(state.params.named_parameters(),
                                            state.opt_state.mu,
                                            state.opt_state.nu))
            and all(p.device.type == "meta" for p in state.params.parameters())
            and tuple(batch["tokens"].shape) == (B // 2, S // 2))


def _worker(rank, world, port, out_dir):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_test_mesh, pctx_for_mesh
    from repro_torch.models.model import (gather_logits, init_caches,
                                          init_lm, init_router_bias,
                                          prefill_step)
    from repro_torch.optim import adafactor, adamw
    from repro_torch.optim.optimizer import Optimizer
    from repro_torch.parallel import collectives, sharding
    from repro_torch.train.loop import (TrainConfig, global_grads,
                                        init_train_state, make_train_step,
                                        state_to_global)

    collectives.init("gloo", world_size=world, rank=rank,
                     init_method=f"tcp://localhost:{port}", timeout_s=120)
    pctx = pctx_for_mesh(make_test_mesh(2, 2), shard_dense=True)
    out = _pairs_backward(pctx.group)
    out["cell_ok"] = _cell_on_mesh(pctx)
    for name in CONFIGS:
        cfg, rcfg = _port_cfgs(name)
        batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}

        def fresh():
            """This rank's shard of the one-rank init (the sharded init
            cuts each tensor of the one-rank stream)."""
            params = init_lm(cfg, rcfg, pctx,
                             torch.Generator().manual_seed(0), device="cpu")
            return params, sharding.lm_param_specs(params, pctx)

        params, specs = fresh()
        out[f"{name}/init_is_slice"] = _init_is_slice(name, params, specs,
                                                      pctx)
        params.requires_grad_(True)
        bias = init_router_bias(cfg, device="cpu")
        loss, _, _, grads = global_grads(params, batch, cfg, rcfg, pctx,
                                         router_bias=bias)
        out[f"{name}/loss"] = float(loss)
        for (n, _), g, sp in zip(params.named_parameters(), grads, specs):
            out[f"{name}/grad/{n}"] = sharding.gather_whole(
                g, sp.dims).numpy()

        for opt_name, make in (("adamw", adamw), ("adafactor", adafactor)):
            params, specs = fresh()
            names = [n for n, _ in params.named_parameters()]
            inner = make(LR)

            def update(gs, st, plist, step, _inner=inner, _specs=specs,
                       _names=names, _key=f"{name}/{opt_name}", **kw):
                for n, g, sp in zip(_names, gs, _specs):
                    g = sharding.gather_whole(g, sp.dims)
                    m = (g.abs() > 1e-3 * g.abs().max()).numpy()
                    k = f"{_key}/mask/{n}"
                    out[k] = m if k not in out else out[k] & m
                return _inner.update(gs, st, plist, step, **kw)

            opt = Optimizer(init=inner.init, update=update)
            state = init_train_state(params, opt, cfg, pctx)
            step = make_train_step(cfg, rcfg, pctx, opt, TrainConfig())
            for _ in range(STEPS):
                state, _m = step(state, batch)
            tree = state_to_global(state, pctx)
            for k, v in tree.items():
                if k.startswith("params/"):
                    out[f"{name}/{opt_name}/final/{k[7:]}"] = \
                        v.detach().numpy()
            out[f"{name}/{opt_name}/restored"] = _restores(
                tree, cfg, rcfg, pctx, inner)

        params, _ = fresh()
        T, t = pctx.ep_size, pctx.ep_rank
        rows = batch["tokens"][pctx.data_rank:pctx.data_rank + 1, :2 * PC]
        caches = init_caches(cfg, 1, 2 * PC, rcfg, device="cpu", pctx=pctx)
        n = PC // T
        with torch.no_grad():
            for c in range(2):
                chunk = rows[:, c * PC + t * n:c * PC + (t + 1) * n]
                logits, caches = prefill_step(params, caches, chunk, cfg,
                                              rcfg, pctx)
                whole = gather_logits(logits, pctx, cfg.vocab_size)
                out[f"{name}/prefill/{c}"] = collectives.all_gather(
                    pctx.data, whole).flatten(0, 1).numpy()
    np.savez(os.path.join(out_dir, f"torch_rank{rank}.npz"), **out)
    collectives.destroy()


def _spawn(out_dir):
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_worker, args=(4, port, out_dir), nprocs=4, join=True)


_JAX = r"""
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.core.balancer import BalancerConfig
from repro.launch.mesh import make_test_mesh, pctx_for_mesh
from repro.models.model import (forward, init_caches, init_lm,
                                init_router_bias, lm_loss, prefill_step)
from repro.models.transformer import RuntimeConfig
from repro.optim import adafactor, adamw
from repro.train.loop import TrainConfig, init_train_state, make_train_step
from repro_torch import convert
from tests.test_torch_sharding_tp import _batch, _port_init

name, (arch, over, moe) = {name!r}, {config!r}
LR, STEPS, PB, PC = {lr}, {steps}, {PB}, {PC}
jax.config.update("jax_disable_most_optimizations", True)   # compile time
pctx = pctx_for_mesh(make_test_mesh(2, 2))
base = get_config(arch)
cfg = dataclasses.replace(base, **over,
                          moe=dataclasses.replace(base.moe, **moe))
rcfg = RuntimeConfig(balancer=BalancerConfig(mode="ultraep", n_slot=2),
                     cf_pair=8.0, cf_slot=8.0, remat=False,
                     scan_layers=False)
batch = {{k: jnp.asarray(v) for k, v in _batch(cfg).items()}}
init = _port_init(name)


def from_port(tree):
    # The JAX tree (one entry per layer) holding the port's values.
    a = lambda n: jnp.asarray(init[n])
    segs, i = [], 0
    for seg in tree.segments:
        blocks = []
        for bs in seg:
            pre = f"layers.{{i}}."
            sub = lambda t, f: None if t is None else t._replace(**{{
                k: a(f"{{pre}}{{f}}.{{k}}") for k, v in t._asdict().items()
                if v is not None}})
            blocks.append(bs._replace(
                norm1=a(pre + "norm1"),
                norm2=None if bs.norm2 is None else a(pre + "norm2"),
                attn=sub(bs.attn, "attn"), ssm=sub(bs.ssm, "ssm"),
                moe=sub(bs.moe, "moe"),
                ffn=None if bs.ffn is None else tuple(
                    a(f"{{pre}}ffn.{{j}}") for j in range(3))))
            i += 1
        segs.append(tuple(blocks))
    return tree._replace(
        embedding=a("embedding"), segments=tuple(segs),
        final_norm=a("final_norm"),
        lm_head=None if tree.lm_head is None else a("lm_head"),
        frontend_proj=None if tree.frontend_proj is None
        else a("frontend_proj"))


def named(tree):
    tp = convert.lm_params(jax.tree.map(np.asarray, tree), cfg,
                           device="cpu")
    return {{n: p.detach().numpy() for n, p in tp.named_parameters()}}


params = from_port(init_lm(jax.random.PRNGKey(0), cfg, rcfg, pctx))
bias = init_router_bias(cfg)
out = {{f"{{name}}/init/{{n}}": v for n, v in init.items()}}


def loss_fn(p):
    logits, aux, _d, _c = forward(p, batch, cfg, rcfg, pctx,
                                  router_bias=bias)
    return lm_loss(logits, batch["targets"]) + aux


loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
out[f"{{name}}/loss"] = np.asarray(loss)
for n, v in named(grads).items():
    out[f"{{name}}/grad/{{n}}"] = v
for opt_name, make in (("adamw", adamw), ("adafactor", adafactor)):
    opt = make(LR)
    state = init_train_state(params, opt, cfg)
    step = jax.jit(make_train_step(cfg, rcfg, pctx, opt, TrainConfig()))
    for _ in range(STEPS):
        state, m = step(state, batch)
    for n, v in named(state.params).items():
        out[f"{{name}}/{{opt_name}}/final/{{n}}"] = v
caches = init_caches(cfg, PB, 2 * PC, rcfg)
pre = jax.jit(lambda p, c, t: prefill_step(p, c, t, cfg, rcfg, pctx))
for c in range(2):
    logits, caches = pre(params, caches,
                         batch["tokens"][:PB, c * PC:(c + 1) * PC])
    out[f"{{name}}/prefill/{{c}}"] = np.asarray(logits)
np.savez({result!r}, **out)
print("DONE")
"""


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """One JAX run a config and the torch run, all at once (each side
    starts from the port's one-rank init and the same numpy batch);
    returns (the JAX results, each torch rank's results)."""
    tmp = tmp_path_factory.mktemp("sharding_tp")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT), os.environ.get("PYTHONPATH", "")]))
    jenv = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = {}
    for name, config in CONFIGS.items():
        code = _JAX.format(name=name, config=config, lr=LR, steps=STEPS,
                           PB=PB, PC=PC, result=str(tmp / f"jax_{name}.npz"))
        procs[name] = subprocess.Popen(
            [sys.executable, "-c", code], cwd=ROOT, env=jenv, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    procs["torch"] = subprocess.Popen(
        [sys.executable, "-c", "from tests.test_torch_sharding_tp import "
         f"_spawn; _spawn({str(tmp)!r})"], cwd=ROOT, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, (name, err[-4000:])
    jax_out = {}
    for name in CONFIGS:
        jax_out.update(np.load(tmp / f"jax_{name}.npz"))
    ranks = [dict(np.load(tmp / f"torch_rank{r}.npz")) for r in range(4)]
    return jax_out, ranks


def _close(got, want, what):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_gradients_match_jax(mesh_run, name):
    jax_out, ranks = mesh_run
    keys = [k for k in jax_out if k.startswith(f"{name}/grad/")]
    assert len(keys) > 10
    for r in ranks:
        _close(r[f"{name}/loss"], jax_out[f"{name}/loss"], "loss")
        for k in keys:
            _close(r[k], jax_out[k], k)


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_params_after_steps_match_jax(mesh_run, name, opt_name):
    """Within TOL of max|p| where each step's gradient exceeded 1e-3 of its
    max|g|; elsewhere within the lr a step that Adam's rounding-decided
    sign (or Adafactor's clipped step) can move an element."""
    jax_out, ranks = mesh_run
    pre = f"{name}/{opt_name}/final/"
    keys = [k for k in jax_out if k.startswith(pre)]
    assert keys
    for k in keys:
        want = jax_out[k]
        assert not np.array_equal(want, jax_out[f"{name}/init/"
                                                + k[len(pre):]])
        for r in ranks:
            mask = r[k.replace("/final/", "/mask/")]
            err = np.abs(r[k] - want)
            assert (err[mask] <= TOL * np.abs(want).max()).all(), \
                (k, err[mask].max(), np.abs(want).max())
            assert (err <= 2 * LR * STEPS).all(), (k, err.max())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_logits_match_jax(mesh_run, name):
    jax_out, ranks = mesh_run
    for c in range(2):
        key = f"{name}/prefill/{c}"
        for r in ranks:
            assert r[key].shape == jax_out[key].shape
            _close(r[key], jax_out[key], key)


def test_collective_pairs_backward(mesh_run):
    """gather_along's backward reduce-scatters, scatter_along's gathers,
    sum_grad's sums; on the model group of 2 (ranks d * 2 + t)."""
    _, ranks = mesh_run
    w = np.arange(12, dtype=np.float64).reshape(3, 4)
    for i, r in enumerate(ranks):
        t = i % 2
        np.testing.assert_array_equal(
            r["pairs/y"], np.repeat([[1.0, 2.0]], 3, 0).repeat(2, 1))
        np.testing.assert_array_equal(r["pairs/dx"],
                                      3 * w[:, 2 * t:2 * t + 2])
        np.testing.assert_array_equal(r["pairs/s"], np.full((2, 3), 3.0))
        np.testing.assert_array_equal(
            r["pairs/dz"], (t + 1) * np.repeat([1.0, 1.0, 2.0, 2.0], 3)
            .reshape(4, 3))
        np.testing.assert_array_equal(r["pairs/b"], np.ones(3))
        np.testing.assert_array_equal(r["pairs/da"], np.full(3, 3.0))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sharded_init_and_convert_are_the_one_rank_slice(mesh_run, name):
    _, ranks = mesh_run
    assert all(bool(r[f"{name}/init_is_slice"]) for r in ranks)


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_state_restores_across_meshes(mesh_run, name, opt_name):
    """The sharded state's global tree (the checkpoint's layout) restores
    onto the same mesh and onto one rank, bitwise."""
    _, ranks = mesh_run
    assert all(bool(r[f"{name}/{opt_name}/restored"]) for r in ranks)


def test_train_cell_on_a_mesh_holds_the_placements(mesh_run):
    _, ranks = mesh_run
    assert all(bool(r["cell_ok"]) for r in ranks)
