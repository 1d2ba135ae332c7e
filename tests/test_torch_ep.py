"""Multi-rank EP over ``torch.distributed`` (gloo, CPU) against the JAX
package under ``shard_map``.

One run of four processes (``torch.multiprocessing``, spawn, one gloo
group) holds every case, beside one JAX run on four virtual CPU devices
(``tests.helpers.run_multidevice``); both read the same numpy inputs from an
``.npz`` and write their results to another.

* The MoE layer at R = 4 against ``repro.moe.layer.moe_layer_local`` under
  ``shard_map``: dispatch modes ``a2a`` and ``replicated``, balancers
  ``ultraep`` and ``none``, a tight ``cap_pair`` that drops items, the int8
  wire, and the replica stream in three reduce-scatters
  (``distribute_chunks``).  y within 1e-5 of max|y| (fp32; the int8 wire at the
  tolerance of ``test_quantized_moe_layer_matches_jax``); drops and
  ``post_max`` per rank and every plan table equal; y also against the
  dense oracle ``moe_ref`` where nothing drops.
* The collective counters of ``parallel/collectives`` (one call of each
  kind, reset just before and read just after): each kind's calls and
  operand bytes equal the tensors' on every rank, and the roofline's
  collective term reads their sum.
* The layer's gradients at R = 4 (``a2a``, ``ultraep``, a load skewed so
  the plan binds replica slots): d(sum y^2) with respect to x, the router
  and the experts, against JAX's ``jax.grad`` under ``shard_map`` and of
  the dense oracle ``moe_ref`` (rtol and atol 5e-4, as
  ``tests/test_multidevice.py``); the replicas' gradients reach their home
  mains through the all-gather of the replica stream's transpose, and the
  tokens' through the exchanges' transposes.  The router is replicated, so
  its gradient is the sum of the ranks'; it is held against ``moe_ref``'s.
* The model at R = 2 (a (data 1, model 2) mesh of ranks 0 and 1, the
  reference's layout: heads and FFN columns over the model axis, the
  decode cache's positions split between the two): a reduced
  GLM-4.5-Air, prefill and decode logits against the port at R = 1
  within 1e-5 of max|logits|.
* ``launch.serve.serve_trace`` on that mesh answers its requests with
  the tokens of the R = 1 run.
"""

import concurrent.futures
import os
import socket
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
R, E, K, D, F, T = 4, 16, 4, 32, 48, 64        # T tokens a rank
LOOSE = (T * K, R * T * K)                      # (cap_pair, cap_slot)
# name: (dispatch mode, balancer, (cap_pair, cap_slot), wire dtype,
#        reduce-scatters of the replica stream)
LAYER_CASES = {
    "a2a_ultraep": ("a2a", "ultraep", LOOSE, "none", 1),
    "replicated_ultraep": ("replicated", "ultraep", LOOSE, "none", 1),
    "a2a_none": ("a2a", "none", LOOSE, "none", 1),
    "replicated_none": ("replicated", "none", LOOSE, "none", 1),
    "a2a_ultraep_tight": ("a2a", "ultraep", (24, 40), "none", 1),
    "a2a_ultraep_wire_int8": ("a2a", "ultraep", LOOSE, "int8", 1),
    "a2a_ultraep_stream_chunks3": ("a2a", "ultraep", LOOSE, "none", 3),
}
PLAN_FIELDS = ("u", "q", "x", "tau", "hosted", "cum_q", "cum_u", "pre_max",
               "post_max")
GRAD_CASES = ("a2a_ultraep",)
GRAD_NAMES = ("x", "router", "w1", "w3", "w2")
SERVE = dict(requests=3, chunk=32, max_new=4, cf=16.0, device="cpu",
             prompt_len=(20, 90))


def _inputs(path):
    """Seeded numpy inputs: R * T tokens whose routing leans on a few
    experts (so the plan replicates), the router and every expert."""
    rng = np.random.default_rng(0)

    def n(shape, fan_in):
        return (rng.standard_normal(shape) * fan_in ** -0.5).astype(np.float32)

    router = n((D, E), D)
    lean = rng.standard_normal(D).astype(np.float32)
    router[:, :3] += 0.6 * lean[:, None]
    x = rng.standard_normal((R * T, D)).astype(np.float32) + lean
    np.savez(path, x=x, router=router, w1=n((E, D, F), D),
             w3=n((E, D, F), D), w2=n((E, F, D), F))


def _configs(mode, balancer, cap, wire, chunks):
    from repro_torch.core.balancer import BalancerConfig
    from repro_torch.moe.gating import GatingConfig
    from repro_torch.moe.layer import MoEConfig

    return MoEConfig(gating=GatingConfig(num_experts=E, top_k=K),
                     balancer=BalancerConfig(mode=balancer, n_slot=2),
                     d_model=D, d_ff=F, ep_size=R, cap_pair=cap[0],
                     cap_slot=cap[1], dispatch_mode=mode, wire_dtype=wire,
                     distribute_chunks=chunks)


def _model(pctx):
    """A reduced GLM-4.5-Air (2 layers) from seed 0 on this rank (``pctx``
    a mesh's context, or None for one rank); prefill of two 32-token rows
    (on a mesh the rank's shard of the chunk), then one decode step.
    Returns the logits (gathered on a mesh)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.reduce import reduced
    from repro_torch.core.balancer import BalancerConfig
    from repro_torch.models.model import (decode_step, gather_logits,
                                          init_caches, init_lm, prefill_step)
    from repro_torch.models.transformer import ParallelCtx, RuntimeConfig

    cfg = reduced(get_config("glm45-106b-a12b"))
    rcfg = RuntimeConfig(balancer=BalancerConfig(mode="ultraep"),
                         cf_pair=16.0, cf_slot=16.0)
    pctx = ParallelCtx() if pctx is None else pctx
    params = init_lm(cfg, rcfg, pctx, torch.Generator().manual_seed(0),
                     device="cpu")
    caches = init_caches(cfg, 2, 64, rcfg, device="cpu", pctx=pctx)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 32)))
    n = 32 // pctx.ep_size
    chunk = toks[:, pctx.ep_rank * n:(pctx.ep_rank + 1) * n]
    whole = dataclasses.replace(pctx, seq_whole=True)
    with torch.inference_mode():
        prefill, caches = prefill_step(params, caches, chunk, cfg, rcfg,
                                       pctx, valid_len=32)
        decode, _ = decode_step(params, caches, toks[:, -1:], cfg, rcfg, pctx)
    return (gather_logits(prefill, pctx, cfg.vocab_size).numpy(),
            gather_logits(decode, whole, cfg.vocab_size).numpy())


def _served_tokens(pctx):
    from repro_torch.launch.serve import serve_trace

    eng = serve_trace("glm45-106b-a12b", pctx=pctx, **SERVE)
    return np.array([r.output for r in sorted(eng.finished,
                                              key=lambda r: r.rid)])


# One call of each counted collective kind and its operand's bytes: dtype,
# shape (R stands for the group's size).
COUNT_CALLS = {"all_gather": ("float32", (3, 5)),
               "all_to_all": ("float32", ("R", 2, 3)),
               "reduce_scatter": ("float64", ("R", 4)),
               "all_reduce": ("float64", (7,)),
               "broadcast": ("int64", (6,)),
               "sendrecv": ("float32", (5,))}


def _collective_counts(group, rank, world) -> dict:
    """Each counted kind once over the group (sendrecv: a ring), the
    counters reset just before and read just after, and the roofline's
    collective term from them."""
    from repro_torch import roofline
    from repro_torch.parallel import collectives

    def t(kind):
        dtype, shape = COUNT_CALLS[kind]
        shape = tuple(world if d == "R" else d for d in shape)
        return torch.ones(shape, dtype=getattr(torch, dtype))

    collectives.reset_counts()
    collectives.all_gather(group, t("all_gather"))
    collectives.all_to_all(group, t("all_to_all"))
    collectives.reduce_scatter(group, t("reduce_scatter"))
    collectives.all_reduce(group, t("all_reduce"))
    collectives.broadcast(group, t("broadcast"), 0)
    recv = torch.empty_like(t("sendrecv"))
    collectives.sendrecv(group, t("sendrecv"), (rank + 1) % world, recv,
                         (rank - 1) % world)
    out = {f"counts/{kind}/{k}": v for kind, c in collectives.counts().items()
           for k, v in c.items()}
    out["counts/roofline_bytes"] = roofline.roofline_terms(
        0.0, 0.0).collective_bytes_per_device
    collectives.reset_counts()
    return out


def _worker(rank, world, port, inputs, out_dir):
    """One rank: every layer case at R = 4, then the model and the serve
    trace at R = 2 on ranks 0 and 1."""
    torch.set_num_threads(1)
    from repro_torch import convert
    from repro_torch.launch.mesh import make_test_mesh, pctx_for_mesh
    from repro_torch.moe import stages
    from repro_torch.moe.layer import moe_layer_local
    from repro_torch.parallel import collectives

    group = collectives.init("gloo", world_size=world, rank=rank,
                             init_method=f"tcp://localhost:{port}",
                             timeout_s=120)
    out = _collective_counts(group, rank, world)
    data = np.load(inputs)
    # The JAX MoEParams' fields, carried across as this rank's share.
    params = convert.moe_params(types.SimpleNamespace(
        router=data["router"], w1=data["w1"], w3=data["w3"], w2=data["w2"],
        shared_w1=None, shared_w3=None, shared_w2=None), n_slot=2,
        device="cpu", ep_rank=rank, ep_size=world)
    for name, case in LAYER_CASES.items():
        cfg = _configs(*case)
        x = torch.from_numpy(data["x"])
        mode = cfg.dispatch_mode
        if mode == "a2a":
            x = x[rank * T:(rank + 1) * T]
        ctx = stages.make_stage_ctx(cfg, group)
        plan = stages.plan_stage(ctx, stages.gate_stage(ctx, x,
                                                        params.router)).plan
        y, _, st = moe_layer_local(x, params, cfg, axis_name=group)
        out[f"{name}/y"] = y.numpy()
        out[f"{name}/drops"] = int(st.drops_dispatch + st.drops_slot)
        for f in PLAN_FIELDS:
            out[f"{name}/plan/{f}"] = getattr(plan, f).numpy()
        if name in GRAD_CASES:
            params.requires_grad_(True)
            xg = x.clone().requires_grad_(True)
            y, _, _ = moe_layer_local(xg, params, cfg, axis_name=group)
            (y ** 2).sum().backward()
            for g, t in zip(GRAD_NAMES, (xg, params.router, params.w1,
                                         params.w3, params.w2)):
                out[f"{name}/grad/{g}"] = t.grad.numpy()
            params.requires_grad_(False)
            for t in params.parameters():
                t.grad = None
    mesh = make_test_mesh(1, 2)                 # ranks 0 and 1
    if mesh is not None:
        pctx = pctx_for_mesh(mesh)
        out["model/prefill"], out["model/decode"] = _model(pctx)
        out["serve/tokens"] = _served_tokens(pctx)
    np.savez(os.path.join(out_dir, f"torch_rank{rank}.npz"), **out)
    collectives.destroy()


def _spawn(inputs, out_dir):
    """Run :func:`_worker` on R ranks (the entry point of the subprocess)."""
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_worker, args=(R, port, inputs, out_dir), nprocs=R, join=True)


_JAX = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.core import balancer as jbal
from repro.core.layout import ExpertLayout
from repro.models.transformer import shard_map_compat as shard_map
from repro.moe.gating import GatingConfig, gate
from repro.moe.layer import MoEConfig, MoEParams, moe_layer_local
from repro.moe.reference import moe_ref
R, E, K, D, F, T = {R}, {E}, {K}, {D}, {F}, {T}
cases = {cases!r}
grad_cases = {grad_cases!r}
data = np.load({inputs!r})
x, router = jnp.asarray(data["x"]), jnp.asarray(data["router"])
ws = [jnp.asarray(data[k]) for k in ("w1", "w3", "w2")]
mesh = Mesh(np.array(jax.devices()).reshape(R), ("model",))
home = ExpertLayout(E, R, 2).home()
out = {{}}
for name, (mode, balancer, cap, wire, chunks) in cases.items():
    gcfg = GatingConfig(num_experts=E, top_k=K)
    bcfg = jbal.BalancerConfig(mode=balancer, n_slot=2)
    cfg = MoEConfig(gating=gcfg, balancer=bcfg, d_model=D, d_ff=F,
                    ep_size=R, cap_pair=cap[0], cap_slot=cap[1],
                    dispatch_mode=mode, wire_dtype=wire,
                    distribute_chunks=chunks)

    def run(x, router, w1, w3, w2):
        y, aux, st = moe_layer_local(x, MoEParams(router, w1, w3, w2), cfg,
                                     axis_name="model")
        return y, (st.drops_dispatch + st.drops_slot)[None], st.post_max[None]

    x_spec = P("model", None) if mode == "a2a" else P(None, None)
    w_spec = P("model", None, None)
    f = shard_map(run, mesh=mesh,
                  in_specs=(x_spec, P(None, None), w_spec, w_spec, w_spec),
                  out_specs=(x_spec, P("model"), P("model")))
    y, drops, post = jax.jit(f)(x, router, *ws)
    out[name + "/y"] = np.asarray(y)
    if name in grad_cases:
        def loss_ep(*args):
            return (f(*args)[0] ** 2).sum()

        def loss_ref(x, router, w1, w3, w2):
            go = gate(x, router, gcfg)
            return (moe_ref(x, go.expert_ids, go.weights, w1, w3, w2)
                    ** 2).sum()

        for tag, fn in (("ep", loss_ep), ("ref", loss_ref)):
            gs = jax.jit(jax.grad(fn, argnums=(0, 1, 2, 3, 4)))(x, router, *ws)
            for g, a in zip({grad_names!r}, gs):
                out[name + "/grad_" + tag + "/" + g] = np.asarray(a)
    out[name + "/drops"] = np.asarray(drops)
    out[name + "/post_max"] = np.asarray(post)
    if mode == "a2a":
        lam = jnp.stack([gate(x[r * T:(r + 1) * T], router, gcfg).counts
                         for r in range(R)])
    else:
        counts = gate(x, router, gcfg).counts
        lam = (jax.nn.one_hot(home, R, dtype=jnp.int32) * counts[:, None]).T
    plan = jbal.solve(lam, home, bcfg)
    for fld in {fields!r}:
        out[name + "/plan/" + fld] = np.asarray(getattr(plan, fld))
np.savez({result!r}, **out)
print("DONE")
"""


@pytest.fixture(scope="module")
def ep_run(tmp_path_factory):
    """Both runs, side by side; returns (inputs, JAX results, each torch
    rank's results)."""
    from tests.helpers import run_multidevice

    tmp = tmp_path_factory.mktemp("ep")
    inputs = str(tmp / "inputs.npz")
    _inputs(inputs)
    jax_out = str(tmp / "jax.npz")
    code = _JAX.format(R=R, E=E, K=K, D=D, F=F, T=T, cases=LAYER_CASES,
                       inputs=inputs, fields=PLAN_FIELDS, result=jax_out,
                       grad_cases=GRAD_CASES, grad_names=GRAD_NAMES)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    torch_cmd = [sys.executable, "-c",
                 f"from tests.test_torch_ep import _spawn; "
                 f"_spawn({inputs!r}, {str(tmp)!r})"]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        jax_job = pool.submit(run_multidevice, code, R, 300)
        torch_job = pool.submit(subprocess.run, torch_cmd, cwd=ROOT, env=env,
                                capture_output=True, text=True, timeout=300)
        assert "DONE" in jax_job.result()
        proc = torch_job.result()
    assert proc.returncode == 0, proc.stderr[-4000:]
    ranks = [dict(np.load(tmp / f"torch_rank{r}.npz")) for r in range(R)]
    return dict(np.load(inputs)), dict(np.load(jax_out)), ranks


def _y(name, ranks):
    """The group's y: the a2a shards in rank order, or the replicated y
    (every rank's must be the same)."""
    if LAYER_CASES[name][0] == "a2a":
        return np.concatenate([r[f"{name}/y"] for r in ranks])
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[f"{name}/y"], ranks[0][f"{name}/y"])
    return ranks[0][f"{name}/y"]


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_ep_layer_matches_jax_shard_map(ep_run, name):
    _, jax_out, ranks = ep_run
    yj = jax_out[f"{name}/y"]
    yt = _y(name, ranks)
    tol = 1e-5 * np.abs(yj).max()
    np.testing.assert_allclose(yt, yj, rtol=0, atol=tol)
    np.testing.assert_array_equal(
        np.array([r[f"{name}/drops"] for r in ranks]), jax_out[f"{name}/drops"])
    np.testing.assert_array_equal(
        np.array([r[f"{name}/plan/post_max"] for r in ranks]),
        jax_out[f"{name}/post_max"])
    if name == "a2a_ultraep_tight":
        assert jax_out[f"{name}/drops"].sum() > 0


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_ep_plan_tables_match_jax(ep_run, name):
    _, jax_out, ranks = ep_run
    for f in PLAN_FIELDS:
        for r in ranks:
            np.testing.assert_array_equal(r[f"{name}/plan/{f}"],
                                          jax_out[f"{name}/plan/{f}"],
                                          err_msg=f)
    if LAYER_CASES[name][1] == "ultraep":
        assert (ranks[0][f"{name}/plan/x"] >= 0).any(), "no replica placed"


@pytest.mark.parametrize("name", [n for n, c in LAYER_CASES.items()
                                  if c[2] == LOOSE and c[3] == "none"])
def test_ep_layer_matches_dense_oracle(ep_run, name):
    from repro_torch.moe.gating import gate
    from repro_torch.moe.reference import moe_ref

    data, _, ranks = ep_run
    assert all(r[f"{name}/drops"] == 0 for r in ranks)
    x = torch.from_numpy(data["x"])
    go = gate(x, torch.from_numpy(data["router"]),
              _configs(*LAYER_CASES[name]).gating)
    ref = moe_ref(x, go.expert_ids, go.weights,
                  *(torch.from_numpy(data[k]) for k in ("w1", "w3", "w2")))
    np.testing.assert_allclose(_y(name, ranks), ref.numpy(), rtol=0,
                               atol=1e-5 * ref.abs().max().item())


@pytest.mark.parametrize("name", GRAD_CASES)
@pytest.mark.parametrize("grad", GRAD_NAMES)
def test_ep_layer_gradients_match_jax_and_dense_oracle(ep_run, name, grad):
    _, jax_out, ranks = ep_run
    shards = [r[f"{name}/grad/{grad}"] for r in ranks]
    # The router is replicated: the group's gradient is the ranks' sum.
    got = sum(shards) if grad == "router" else np.concatenate(shards)
    refs = ["ref"] if grad == "router" else ["ep", "ref"]
    for tag in refs:
        np.testing.assert_allclose(got, jax_out[f"{name}/grad_{tag}/{grad}"],
                                   rtol=5e-4, atol=5e-4, err_msg=tag)
    assert np.abs(got).max() > 0
    # The skewed load binds replica slots, so replica gradients were
    # reduced onto their mains.
    assert (ranks[0][f"{name}/plan/x"] >= 0).any()


@pytest.mark.parametrize("step", ["prefill", "decode"])
def test_ep_model_matches_single_rank(ep_run, step):
    _, _, ranks = ep_run
    one = dict(zip(("prefill", "decode"), _model(None)))[step]
    for r in ranks[:2]:
        np.testing.assert_allclose(r[f"model/{step}"], one, rtol=0,
                                   atol=1e-5 * np.abs(one).max())


def test_collective_counters_match_tensor_bytes(ep_run):
    """``parallel/collectives`` counts one call of each kind and the
    bytes of its operand on every rank over gloo (R = 4), and the
    roofline's collective term reads their sum."""
    _, _, ranks = ep_run
    total = 0
    for kind, (dtype, shape) in COUNT_CALLS.items():
        n = int(np.prod([R if d == "R" else d for d in shape]))
        nbytes = n * np.dtype(dtype).itemsize
        total += nbytes
        for r in ranks:
            assert r[f"counts/{kind}/calls"] == 1, kind
            assert r[f"counts/{kind}/bytes"] == nbytes, kind
    for r in ranks:
        assert r["counts/roofline_bytes"] == total


def test_ep_serve_gives_single_rank_tokens(ep_run):
    _, _, ranks = ep_run
    one = _served_tokens(None)
    assert one.shape == (SERVE["requests"], SERVE["max_new"])
    for r in ranks[:2]:
        np.testing.assert_array_equal(r["serve/tokens"], one)
