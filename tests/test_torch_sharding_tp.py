"""The reference's layout on a mesh (``repro_torch.parallel.sharding``:
one layout for every step) against the JAX package's.

* Placements: for every registered config at full width, on the 16 x 16
  pod, the 2 x 16 x 16 multi-pod and a (data 16, rack 2, model 8) rack
  mesh, each parameter's entries equal the reference's ``lm_param_specs``
  (``scan_layers=False``, one entry per layer), dimension by dimension,
  the batch axes one entry; so do ``batch_specs`` (train, prefill and
  decode), ``opt_state_specs`` (AdamW and Adafactor),
  ``activation_spec`` and ``cache_specs`` (one entry a layer), and
  ``topology_from_ctx`` on a flat and a factored mesh.  The reference
  reads only ``pctx.mesh.shape``, so a stand-in with that dict takes the
  mesh's place and no device is needed.  A shard's shape
  (``shard_shape``) divides each placed dimension by its axes' sizes.
* Computation: one run of four gloo processes on a (data 2, model 2)
  mesh (``torch.multiprocessing``, spawn) beside JAX on the same mesh of
  four virtual CPU devices, one process a config, all started at once:
  both sides start from the port's one-rank init (the ranks' sharded
  init cuts it; the JAX run puts its values into the reference's tree)
  and one numpy batch.  Two configs train: ``gqa``, ``tiny-moe`` with a
  dense first layer and a shared expert (the vocabulary 128 divides by
  2), and ``mla``, ``tiny-mla-moe`` (q_lora and kv_lora 16).  The loss
  and every gradient (gathered) of one global batch (B 4, S 16), and of
  the same batch cut to S 15, where the residual stream stays whole on
  every model rank, the parameters after two AdamW and after two
  Adafactor steps on it (within ``TOL`` of their max|p| where each
  step's gradient exceeded 1e-3 of its max|g|, as
  ``tests/test_torch_train_ep.py`` compares them), and one prefill chunk
  of C 7 (a whole stream).  Those two and a third, ``hybrid``
  (``tiny-hybrid``: Mamba layers, whose decode state stays whole on every
  model rank), serve: two prefill chunks (B 2, C 8, or 16 at the SSD
  chunk) into the sequence-sharded cache, then ``DEC`` decode steps, the
  reference's ``decode_step`` jitted with its ``(lm_param_specs,
  cache_specs, batch_specs)`` shardings; each call's logits gathered over
  both axes, within ``TOL`` of each tensor's max|ref|, and after the
  steps each rank's cache shard against the same slice of JAX's cache.
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
SW, CW = 15, 7           # whole-stream train sequence and prefill chunk
# The gradient runs: (key prefix, sequence, capacity factor).  At S 15 the
# capacities count 7 of a rank's 15 positions (the reference's floor of
# S / T), so ``mla``'s island drops items at factor 8, and its model
# ranks' copies then differ (ROADMAP section 3): the port takes the first
# copy, as the array's value, and matches the reference's loss there; the
# gradients are held where nothing drops (factor 32).
RUNS = (("", S, 8.0), ("whole/", SW, 8.0), ("whole_free/", SW, 32.0))
PB, DEC = 2, 3           # prefill rows (one a data row), decode steps
# name: (registered config, ModelConfig overrides, MoEArch overrides);
# CONFIGS train and serve, SERVE_CONFIGS serve.
CONFIGS = {
    "gqa": ("tiny-moe", {"d_ff": 64},
            {"first_dense_layers": 1, "n_shared_experts": 1,
             "shared_d_ff": 32}),
    "mla": ("tiny-mla-moe", {}, {}),
}
SERVE_CONFIGS = dict(CONFIGS, hybrid=("tiny-hybrid", {}, {}))
PC = {"gqa": 8, "mla": 8, "hybrid": 16}   # prefill chunk (SSD chunk: 16)


def _max_seq(name) -> int:
    """The decode cache: two chunks and the decode steps, in whole blocks
    of the model axis."""
    return 2 * PC[name] + DEC + 1
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


@pytest.mark.parametrize("arch", _archs())
def test_cache_specs_equal_the_reference(arch):
    """Every layer's decode cache entries on the three production meshes,
    at the decode shapes' global batch and at one that does not divide
    (the reference's ``cache_specs`` with ``scan_layers=False``)."""
    from repro.configs import get_config as j_get_config
    from repro.models.transformer import RuntimeConfig
    from repro.parallel import sharding as jsh
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.parallel import sharding

    cfg, jcfg = get_config(arch), j_get_config(arch)
    batches = {s.global_batch for s in SHAPES.values()
               if s.kind == "decode"} | {3}
    for shape in MESHES.values():
        jp = _jax_pctx(shape)
        for gb in batches:
            want = [e for seg in jsh.cache_specs(
                jcfg, RuntimeConfig(scan_layers=False), jp, gb) for e in seg]
            got = sharding.cache_specs(cfg, sharding.mesh_axes(shape), gb)
            assert len(got) == len(want) == cfg.num_layers
            for g, w in zip(got, want):
                assert type(g).__name__ == type(w).__name__
                assert [_entries(e) for e in g] == [_entries(e) for e in w]


def test_topology_from_ctx_equals_the_reference():
    from repro.parallel import sharding as jsh
    from repro_torch.models.transformer import ParallelCtx
    from repro_torch.parallel import sharding

    for shape in (MESHES["pod"], MESHES["rack"], {"data": 2, "rack": 4,
                                                   "model": 2}):
        want = jsh.topology_from_ctx(_jax_pctx(shape), inter_beta=5e9)
        got = sharding.topology_from_ctx(
            ParallelCtx(mesh_axes=tuple(shape.items())), inter_beta=5e9)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), shape


def test_decode_cache_holds_whole_blocks():
    """A mesh's decode cache holds max_seq / T positions a rank: a
    max_seq that does not divide raises, naming it."""
    from types import SimpleNamespace

    from repro_torch.configs import get_config
    from repro_torch.models.model import init_caches
    from repro_torch.models.transformer import ParallelCtx, RuntimeConfig

    cfg = get_config("tiny-moe")
    pctx = ParallelCtx(group=SimpleNamespace(size=2, rank=1, factored=False),
                       mesh_axes=(("data", 1), ("model", 2)))
    caches = init_caches(cfg, 3, 10, RuntimeConfig(), device="meta",
                         pctx=pctx)
    assert tuple(caches[0].k.shape) == (3, 5, 2, 8)
    with pytest.raises(ValueError, match="max_seq 9 does not split"):
        init_caches(cfg, 3, 9, RuntimeConfig(), device="meta", pctx=pctx)


# ------------------------------------------------ the four-rank run ----

def _port_cfgs(name):
    from repro_torch.configs import get_config
    from repro_torch.core.balancer import BalancerConfig
    from repro_torch.models.transformer import RuntimeConfig

    arch, over, moe = SERVE_CONFIGS[name]
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


def _serve_tokens(cfg, name) -> np.ndarray:
    """(PB, two chunks + DEC) tokens: the prompts, then the decode
    steps' inputs."""
    rng = np.random.default_rng(2)
    return rng.integers(0, cfg.vocab_size,
                        (PB, 2 * PC[name] + DEC)).astype(np.int64)


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
    c = torch.ones(2, dtype=torch.float64, requires_grad=True)
    d = collectives.reduce_whole(g, c * (r + 1))
    (d * (r + 1)).sum().backward()
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
            "pairs/b": b.detach().numpy(), "pairs/da": a.grad.numpy(),
            "pairs/d": d.detach().numpy(), "pairs/dc": c.grad.numpy()}


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
        state = state_from_global(init_train_state(params, opt, cfg),
                                  tree, ctx)
        back = state_to_global(state, ctx)
        ok = ok and all(torch.equal(torch.as_tensor(back[k]),
                                    torch.as_tensor(v))
                        for k, v in tree.items() if k != "step")
    return ok


def _decode_cell_on_mesh(pctx) -> bool:
    """The decode cell on the mesh: ``in_shardings`` (params, caches,
    batch) with the caches' ``cache_specs``, and caches of this rank's
    shard on the ``meta`` device."""
    from repro_torch.launch.specs import build_cell
    from repro_torch.models.model import init_caches
    from repro_torch.parallel import sharding

    cell = build_cell("tiny-moe", "decode_32k", pctx)
    pspecs, cspecs, bspecs = cell.in_shardings
    cfg, shape = cell.meta["cfg"], cell.meta["shape"]
    ax = sharding.from_ctx(pctx)
    glob = init_caches(cfg, shape.global_batch, shape.seq_len,
                       cell.meta["rcfg"], device="meta")
    caches = cell.arg_shapes[1]
    return (pspecs == sharding.param_layout(cfg, ax)
            and cspecs == sharding.cache_specs(cfg, ax, shape.global_batch)
            and bspecs == sharding.batch_specs(cfg, ax, "decode",
                                               shape.global_batch)
            and all(tuple(a.shape) == sharding.shard_shape(sp, g.shape,
                                                           ax.sizes)
                    and a.device.type == "meta"
                    for c, s, gl in zip(caches, cspecs, glob)
                    for a, sp, g in zip(c, s, gl)))


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
    from repro_torch.models.model import init_lm
    from repro_torch.parallel import collectives, sharding

    collectives.init("gloo", world_size=world, rank=rank,
                     init_method=f"tcp://localhost:{port}", timeout_s=120)
    pctx = pctx_for_mesh(make_test_mesh(2, 2))
    out = _pairs_backward(pctx.group)
    out["cell_ok"] = _cell_on_mesh(pctx)
    out["decode_cell_ok"] = _decode_cell_on_mesh(pctx)
    for name in SERVE_CONFIGS:
        cfg, rcfg = _port_cfgs(name)
        batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}

        def fresh():
            """This rank's shard of the one-rank init (the sharded init
            cuts each tensor of the one-rank stream)."""
            params = init_lm(cfg, rcfg, pctx,
                             torch.Generator().manual_seed(0), device="cpu")
            return params, sharding.lm_param_specs(params, pctx)

        if name in CONFIGS:
            _train_on_mesh(name, cfg, rcfg, pctx, batch, fresh, out)
        params, _ = fresh()
        _serve_on_mesh(name, cfg, rcfg, pctx, params, out)
    np.savez(os.path.join(out_dir, f"torch_rank{rank}.npz"), **out)
    collectives.destroy()


def _train_on_mesh(name, cfg, rcfg, pctx, batch, fresh, out):
    """The train config's checks on one rank: the init, the loss and the
    gradients at S and at SW (a whole stream), the optimizers' steps, and
    a whole-stream prefill chunk of CW."""
    import dataclasses as dc

    from repro_torch.models.model import (gather_logits, init_caches,
                                          init_router_bias, prefill_step)
    from repro_torch.optim import adafactor, adamw
    from repro_torch.optim.optimizer import Optimizer
    from repro_torch.parallel import collectives, sharding
    from repro_torch.train.loop import (TrainConfig, global_grads,
                                        init_train_state, make_train_step,
                                        state_to_global)

    params, specs = fresh()
    out[f"{name}/init_is_slice"] = _init_is_slice(name, params, specs, pctx)
    params.requires_grad_(True)
    bias = init_router_bias(cfg, device="cpu")
    for tag, seq, cf in RUNS:
        rc = dc.replace(rcfg, cf_pair=cf, cf_slot=cf)
        loss, drops, _, grads = global_grads(
            params, {k: v[:, :seq] for k, v in batch.items()}, cfg, rc,
            pctx, router_bias=bias)
        out[f"{name}/{tag}loss"] = float(loss)
        out[f"{name}/{tag}drops"] = int(drops)
        for (n, _), g, sp in zip(params.named_parameters(), grads, specs):
            out[f"{name}/{tag}grad/{n}"] = sharding.gather_whole(
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
        state = init_train_state(params, opt, cfg)
        step = make_train_step(cfg, rcfg, pctx, opt, TrainConfig())
        for _ in range(STEPS):
            state, _m = step(state, batch)
        tree = state_to_global(state, pctx)
        for k, v in tree.items():
            if k.startswith("params/"):
                out[f"{name}/{opt_name}/final/{k[7:]}"] = v.detach().numpy()
        out[f"{name}/{opt_name}/restored"] = _restores(tree, cfg, rcfg, pctx,
                                                       inner)

    params, _ = fresh()
    toks = torch.from_numpy(_serve_tokens(cfg, name))
    whole = dc.replace(pctx, seq_whole=True)
    caches = init_caches(cfg, PB, _max_seq(name), rcfg, device="cpu",
                         pctx=pctx)
    with torch.no_grad():
        logits, _ = prefill_step(params, caches,
                                 toks[pctx.data_rank:pctx.data_rank + 1, :CW],
                                 cfg, rcfg, whole)
    out[f"{name}/whole/prefill"] = collectives.all_gather(
        pctx.data, gather_logits(logits, whole, cfg.vocab_size)
    ).flatten(0, 1).numpy()


def _serve_on_mesh(name, cfg, rcfg, pctx, params, out):
    """Two prefill chunks into the sequence-sharded cache, then DEC
    decode steps (each call's logits gathered over both axes), the
    rank's cache shard after them, and whether each cache entry has the
    shape of its ``cache_specs`` shard."""
    import dataclasses as dc

    from repro_torch.models.attention import KVCache
    from repro_torch.models.model import (decode_step, gather_logits,
                                          init_caches, prefill_step)
    from repro_torch.parallel import collectives, sharding

    T, t, d = pctx.ep_size, pctx.ep_rank, pctx.data_rank
    rows = torch.from_numpy(_serve_tokens(cfg, name))[d:d + 1]
    max_seq, C = _max_seq(name), PC[name]
    caches = init_caches(cfg, PB, max_seq, rcfg, device="cpu", pctx=pctx)
    specs = sharding.cache_specs(cfg, sharding.from_ctx(pctx), PB)
    glob = init_caches(cfg, PB, max_seq, rcfg, device="meta")

    def want(spec, g, attn):
        if attn:
            return sharding.shard_shape(spec, g.shape, dict(pctx.mesh_axes))
        # A Mamba state: its data rank's rows, whole over the model axis.
        return (g.shape[0] // pctx.data_size,) + tuple(g.shape[1:])

    out[f"{name}/cache_ok"] = all(
        tuple(a.shape) == want(sp, g, isinstance(c, KVCache))
        for c, s, gl in zip(caches, specs, glob)
        for a, sp, g in zip(c, s, gl))
    whole = dc.replace(pctx, seq_whole=True)

    def gathered(logits, ctx):
        return collectives.all_gather(pctx.data, gather_logits(
            logits, ctx, cfg.vocab_size)).flatten(0, 1).numpy()

    n = C // T
    with torch.no_grad():
        for c in range(2):
            chunk = rows[:, c * C + t * n:c * C + (t + 1) * n]
            logits, caches = prefill_step(params, caches, chunk, cfg, rcfg,
                                          pctx)
            out[f"{name}/prefill/{c}"] = gathered(logits, pctx)
        for i in range(DEC):
            logits, caches = decode_step(
                params, caches, rows[:, 2 * C + i:2 * C + i + 1], cfg, rcfg,
                pctx)
            out[f"{name}/decode/{i}"] = gathered(logits, whole)
    for i, entry in enumerate(caches):
        for field, a in entry._asdict().items():
            out[f"{name}/cache/{i}/{field}"] = a.numpy()


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
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.models.model import decode_step
from repro.parallel import sharding as jsh
from tests.test_torch_sharding_tp import _batch, _port_init, _serve_tokens

name, (arch, over, moe) = {name!r}, {config!r}
LR, STEPS, PB, PC, DEC, SW, CW = {lr}, {steps}, {PB}, {PC}, {DEC}, {SW}, {CW}
TRAIN, MAX_SEQ = {train}, {max_seq}
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


def loss_fn(p, b, rc):
    logits, aux, _d, _c = forward(p, b, cfg, rc, pctx, router_bias=bias)
    return lm_loss(logits, b["targets"]) + aux


for tag, seq, cf in {runs!r} if TRAIN else ():
    rc = dataclasses.replace(rcfg, cf_pair=cf, cf_slot=cf)
    vg = jax.jit(jax.value_and_grad(lambda p, b: loss_fn(p, b, rc)))
    loss, grads = vg(params, {{k: v[:, :seq] for k, v in batch.items()}})
    out[f"{{name}}/{{tag}}loss"] = np.asarray(loss)
    for n, v in named(grads).items():
        out[f"{{name}}/{{tag}}grad/{{n}}"] = v
for opt_name, make in (("adamw", adamw), ("adafactor", adafactor)) if TRAIN \
        else ():
    opt = make(LR)
    state = init_train_state(params, opt, cfg)
    step = jax.jit(make_train_step(cfg, rcfg, pctx, opt, TrainConfig()))
    for _ in range(STEPS):
        state, m = step(state, batch)
    for n, v in named(state.params).items():
        out[f"{{name}}/{{opt_name}}/final/{{n}}"] = v
toks = jnp.asarray(_serve_tokens(cfg, name))
pre = jax.jit(lambda p, c, t: prefill_step(p, c, t, cfg, rcfg, pctx))
if TRAIN:
    logits, _ = pre(params, init_caches(cfg, PB, MAX_SEQ, rcfg), toks[:, :CW])
    out[f"{{name}}/whole/prefill"] = np.asarray(logits)
caches = init_caches(cfg, PB, MAX_SEQ, rcfg)
for c in range(2):
    logits, caches = pre(params, caches, toks[:, c * PC:(c + 1) * PC])
    out[f"{{name}}/prefill/{{c}}"] = np.asarray(logits)
# Decode on the reference's placement: parameters, the sequence-sharded
# cache and the batch as its cells place them.
is_p = lambda x: isinstance(x, P)
shard = lambda specs: jax.tree.map(lambda sp: NamedSharding(pctx.mesh, sp),
                                   specs, is_leaf=is_p)
put = lambda tree, specs: jax.device_put(tree, shard(specs))
pspecs = jsh.lm_param_specs(cfg, rcfg, pctx)
cspecs = jsh.cache_specs(cfg, rcfg, pctx, PB)
tspec = jsh.batch_specs(cfg, pctx, "decode", PB)["tokens"]


def dec_fn(p, c, t):
    logits, new = decode_step(p, c, t, cfg, rcfg, pctx)
    return logits, tuple(tuple(seg) for seg in new)     # cspecs' structure


dec = jax.jit(dec_fn, in_shardings=(shard(pspecs), shard(cspecs),
                                    shard(tspec)))
params = put(params, pspecs)
caches = put(tuple(tuple(seg) for seg in caches), cspecs)
for i in range(DEC):
    t = put(toks[:, 2 * PC + i:2 * PC + i + 1], tspec)
    logits, caches = dec(params, caches, t)
    out[f"{{name}}/decode/{{i}}"] = np.asarray(logits)
for i, entry in enumerate(e for seg in caches for e in seg):
    for field, a in entry._asdict().items():
        out[f"{{name}}/cache/{{i}}/{{field}}"] = np.asarray(a)
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
    for name, config in SERVE_CONFIGS.items():
        code = _JAX.format(name=name, config=config, lr=LR, steps=STEPS,
                           PB=PB, PC=PC[name], DEC=DEC, SW=SW, CW=CW,
                           train=name in CONFIGS, max_seq=_max_seq(name),
                           runs=RUNS,
                           result=str(tmp / f"jax_{name}.npz"))
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
    for name in SERVE_CONFIGS:
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


@pytest.mark.parametrize("name", list(SERVE_CONFIGS))
def test_prefill_logits_match_jax(mesh_run, name):
    jax_out, ranks = mesh_run
    for c in range(2):
        key = f"{name}/prefill/{c}"
        for r in ranks:
            assert r[key].shape == jax_out[key].shape
            _close(r[key], jax_out[key], key)


@pytest.mark.parametrize("name", list(SERVE_CONFIGS))
def test_decode_logits_match_jax(mesh_run, name):
    """Each decode step's logits on the sequence-sharded cache (gathered
    over both axes) against the reference's ``decode_step`` on its
    placement."""
    jax_out, ranks = mesh_run
    for i in range(DEC):
        key = f"{name}/decode/{i}"
        for r in ranks:
            assert r[key].shape == jax_out[key].shape == (PB, 1, 128)
            _close(r[key], jax_out[key], key)


@pytest.mark.parametrize("name", list(SERVE_CONFIGS))
def test_decode_cache_shards_match_jax(mesh_run, name):
    """After the decode steps each rank's cache is its shard of the
    reference's (``cache_specs``: its data row, and for attention its
    block of positions; a Mamba state whole over the model axis), with
    the shapes of its shard; the lengths equal."""
    jax_out, ranks = mesh_run
    pre = f"{name}/cache/"
    keys = [k for k in jax_out if k.startswith(pre)]
    assert len(keys) >= 6
    for i, r in enumerate(ranks):
        d, t = divmod(i, 2)
        assert bool(r[f"{name}/cache_ok"])
        for k in keys:
            want = jax_out[k][d:d + 1]
            if k.endswith("/length"):
                np.testing.assert_array_equal(r[k], want, err_msg=k)
                assert int(want[0]) == 2 * PC[name] + DEC
                continue
            if r[k].shape != want.shape:          # a block of positions
                n = r[k].shape[1]
                assert want.shape[1] == 2 * n
                want = want[:, t * n:(t + 1) * n]
            _close(r[k], want, k)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_whole_stream_loss_and_gradients_match_jax(mesh_run, name):
    """S 15 does not divide by the model axis of 2: the residual stream
    stays whole on every model rank (the reference's ``wsc``), the
    row-parallel exits are all-reduced, and every model rank routes the
    same tokens through the EP layer.  The loss where the island drops
    items (``mla`` at factor 8, see ``RUNS``), and the loss and every
    gradient where it does not."""
    jax_out, ranks = mesh_run
    keys = [k for k in jax_out if k.startswith(f"{name}/whole_free/grad/")]
    assert len(keys) > 10
    if name == "mla":
        assert all(r["mla/whole/drops"] > 0 for r in ranks)
    for r in ranks:
        assert r[f"{name}/whole_free/drops"] == 0
        for tag in ("whole", "whole_free"):
            _close(r[f"{name}/{tag}/loss"], jax_out[f"{name}/{tag}/loss"],
                   tag)
        for k in keys:
            _close(r[k], jax_out[k], k)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_whole_stream_prefill_matches_jax(mesh_run, name):
    jax_out, ranks = mesh_run
    key = f"{name}/whole/prefill"
    for r in ranks:
        assert r[key].shape == jax_out[key].shape == (PB, CW, 128)
        _close(r[key], jax_out[key], key)


def test_collective_pairs_backward(mesh_run):
    """gather_along's backward reduce-scatters, scatter_along's gathers,
    sum_grad's and reduce_whole's sum; on the model group of 2 (ranks
    d * 2 + t)."""
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
        np.testing.assert_array_equal(r["pairs/d"], np.full(2, 3.0))
        np.testing.assert_array_equal(r["pairs/dc"], np.full(2, 3.0 * (t + 1)))


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


def test_decode_cell_on_a_mesh_holds_the_cache_specs(mesh_run):
    _, ranks = mesh_run
    assert all(bool(r["decode_cell_ok"]) for r in ranks)
