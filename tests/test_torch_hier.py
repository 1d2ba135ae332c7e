"""The two-level rack tier of the port against the JAX package.

CPU only (the kernels' rack modes are held against their plain versions
in ``test_torch_plan_solve.py`` and ``test_torch_gating_topk.py`` on the
card, and in chip_smoke.py):

* The rack-aware planner (``rack_size`` L, with and without the demand
  tie-break) against JAX's ``solve_replication``, ``solve_reroute`` and
  tier volumes: the whole ``Plan``, tier fields included, integer-equal at
  R 4, 16 and 64 with L dividing R, over three popularity laws (Zipf 1.0,
  four hot experts, and each rack's tokens on a share of the experts, so
  the demand incidence is not all ones).  One rack is the flat plan, bit
  for bit; ``plan_solve_ref`` in rack mode equals JAX's
  ``solve_replication``; the wrapper's int32 bound in rack mode.
* ``MoEConfig``'s construction-time refusals (mirrors
  ``tests/test_hier.py::test_config_validation_at_construction``).
* One spawned run of four gloo processes on the CPU, beside one JAX run on
  four virtual devices, both on an ``.npz`` of numpy inputs:
  ``two_hop_all_to_all`` (forward, reverse, and started asynchronously)
  against ``wire_oracle.two_hop_wire`` and the flat exchange, on fp32 and
  int8-encoded rows; the layer at R = 4 factored as 2 racks x 2 lanes
  (``hier_a2a``; with a rack limit of 1; ``replicated``) against
  ``repro.moe.layer.moe_layer_local`` under ``shard_map`` on a ``(2, 2)``
  (rack, model) mesh within 1e-5 of max|y|, with its plan tables and tier
  statistics equal, and bitwise against the port's flat R = 4 layer on the
  same weights (rank-major numbering: ``convert``'s per-rank shares are
  the same on both groups; ``replicated`` within JAX's own 1e-6, its rank
  merge summing in another order); its gradients d(sum y^2) against
  ``jax.grad`` under ``shard_map`` (rtol and atol 5e-4, as
  ``test_torch_ep.py``).
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

from repro_torch.analysis import plan_check
from repro_torch.core import planner
from repro_torch.kernels.plan_solve import ops

ROOT = Path(__file__).resolve().parents[1]
RACKS, LANES = 2, 2
R, E, K, D, F, T = RACKS * LANES, 16, 4, 32, 48, 64
CAP = (T * K, R * T * K)
PLAN_FIELDS = ("u", "q", "x", "tau", "hosted", "cum_q", "cum_u", "pre_max",
               "post_max", "tier_tokens", "tier_replicas", "gate_tier_tokens")
# name: (dispatch mode, racks of the config, rack limit of the gate)
LAYER_CASES = {
    "hier": ("hier_a2a", RACKS, 0),
    "hier_limit": ("hier_a2a", RACKS, 1),
    "hier_replicated": ("replicated", RACKS, 0),
}
# The same cases at a capacity that drops (cap_pair, cap_slot): per-rank
# drops equal to JAX's, and apart from the payload screen's count.
TIGHT_CAP = (256, 70)
TIGHT_CASES = {f"{n}_tight": c for n, c in LAYER_CASES.items()}
# The port's flat R = 4 twin of each factored case.
FLAT_TWIN = {"hier": ("a2a", 1, 0), "hier_limit": ("a2a", 1, 1),
             "hier_replicated": ("replicated", 1, 0)}
GRAD_NAMES = ("x", "router", "w1", "w3", "w2")
LAWS = ("zipf", "hot4", "racked")
RACK_CASES = [(4, 2), (16, 4), (64, 8)]


@pytest.fixture(autouse=True)
def _verify_plans():
    """Every plan the port's balancer solves here goes through its static
    check (``repro_torch.analysis.plan_check``), as the reference's
    tests/conftest.py does for the JAX package's."""
    with plan_check.plan_verification():
        yield


def _lam(R_, E_, L, law, seed, tokens=256, k=4):
    """(R, E) int64 load; ``racked``: each rack's tokens on its own third
    of the experts plus a few shared ones, so racks differ in what they
    demand."""
    rng = np.random.default_rng(seed)
    rows = []
    for r in range(R_):
        if law == "zipf":
            p = 1.0 / np.arange(1, E_ + 1)
            p = p[np.random.default_rng(seed + 1).permutation(E_)]
        elif law == "hot4":
            p = np.full(E_, 0.5 / (E_ - 4))
            p[np.random.default_rng(seed + 1).choice(E_, 4,
                                                     replace=False)] = 0.125
        else:
            g = r // L
            p = np.zeros(E_)
            p[np.random.default_rng(seed + g).choice(E_, E_ // 3,
                                                     replace=False)] = 1.0
            p[:2] = 1.0
        rows.append(rng.multinomial(tokens * k, p / p.sum()))
    return np.stack(rows).astype(np.int64)


def _home(R_, E_):
    return np.repeat(np.arange(R_), E_ // R_).astype(np.int64)


@pytest.mark.parametrize("demand", [False, True], ids=["plain", "demand"])
@pytest.mark.parametrize("law", LAWS)
@pytest.mark.parametrize("R_,L", RACK_CASES)
def test_rack_plan_matches_jax(R_, L, law, demand):
    import jax.numpy as jnp

    from repro.core import planner as jp

    E_ = 2 * R_
    lam = _lam(R_, E_, L, law, seed=R_ + L)
    home = _home(R_, E_)
    gate_tiers = np.array([5, 6, 7], dtype=np.int64)
    j = jp.solve_plan(jnp.asarray(lam, jnp.int32), jnp.asarray(home),
                      n_slot=2, rack_size=L, demand_tiebreak=demand,
                      gate_tier_tokens=jnp.asarray(gate_tiers, jnp.int32))
    t = planner.solve_plan(torch.from_numpy(lam), torch.from_numpy(home),
                           n_slot=2, rack_size=L, demand_tiebreak=demand,
                           gate_tier_tokens=torch.from_numpy(gate_tiers))
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    # The reroute and the tier volumes on their own, on JAX's quota table.
    u = np.asarray(j.u)
    q = planner.solve_reroute(torch.from_numpy(lam), torch.from_numpy(u),
                              rack_size=L)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jp.solve_reroute(
        jnp.asarray(lam, jnp.int32), jnp.asarray(u), rack_size=L)))
    np.testing.assert_array_equal(
        planner.token_tier_volumes(q, L).numpy(),
        np.asarray(jp.token_tier_volumes(jnp.asarray(q.numpy()), L)))
    np.testing.assert_array_equal(
        planner.replica_tier_volumes(torch.from_numpy(u),
                                     torch.from_numpy(home), L).numpy(),
        np.asarray(jp.replica_tier_volumes(jnp.asarray(u), jnp.asarray(home),
                                           L)))
    assert int(t.tier_tokens.sum()) == int(lam.sum())


@pytest.mark.parametrize("demand", [False, True], ids=["plain", "demand"])
def test_rack_plan_solve_ref_matches_jax_solve_replication(demand):
    import jax.numpy as jnp

    from repro.core import planner as jp

    R_, L, E_ = 16, 4, 32
    lam = _lam(R_, E_, L, "racked", seed=3)
    home = _home(R_, E_)
    lam_e = torch.from_numpy(lam).sum(dim=0)
    ht = torch.from_numpy(home)
    ell = planner._rank_load(lam_e, ht, R_)
    rexp = planner._expert_order(lam_e, ht, R_)
    stats = torch.zeros(2, dtype=torch.int32)
    u, tau = ops.plan_solve_ref(
        lam_e, ell, ht, rexp, n_slot=2, u_min=1, max_replicas_per_expert=R_,
        stats=stats, rack_size=L,
        lam=torch.from_numpy(lam) if demand else None)
    ju, jtau = jp.solve_replication(jnp.asarray(lam, jnp.int32),
                                    jnp.asarray(home), n_slot=2,
                                    rack_size=L, demand_tiebreak=demand)
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    assert int(tau) == int(jtau)
    assert stats[0] > 0 and stats[1] > 0


def test_one_rack_is_the_flat_plan_bitwise():
    R_, E_ = 8, 32
    lam = torch.from_numpy(_lam(R_, E_, R_, "hot4", seed=5))
    home = torch.from_numpy(_home(R_, E_))
    flat = planner.solve_plan(lam, home, n_slot=2)
    for demand in (False, True):
        one = planner.solve_plan(lam, home, n_slot=2, rack_size=R_,
                                 demand_tiebreak=demand)
        for f in planner.Plan._fields[:9]:
            assert torch.equal(getattr(one, f), getattr(flat, f)), f
        assert one.tier_tokens[2] == 0 and one.tier_replicas[1] == 0


def test_rack_mode_load_bound_and_arguments():
    """The wrapper's int32 guard in rack mode is 2^31 over the slack's
    scale (2, or 4 with the demand tie-break), named in the message, and
    also over P with k-ary probing and 2^30 with health weights; the
    argument checks run before any launch.  Health weights and k-ary
    probing solve in rack mode."""
    assert ops.load_limit(None, False) == 2 ** 31
    assert ops.load_limit(4, False) == 2 ** 30
    assert ops.load_limit(4, True) == 2 ** 29
    assert ops.load_limit(4, False, 8) == 2 ** 28
    assert ops.load_limit(None, False, 1, True) == 2 ** 30
    lam = torch.ones((4, 8), dtype=torch.int64)
    lam_e, ell = lam.sum(0), torch.full((4,), 8, dtype=torch.int64)
    home = torch.arange(8) // 2
    rexp = torch.arange(8).reshape(4, 2)
    with pytest.raises(ValueError, match="slack scale"):
        ops._check(lam_e, ell, home, rexp, 2 ** 29, 2, lam, n_slot=2)
    with pytest.raises(ValueError, match="must divide"):
        ops._check(lam_e, ell, home, rexp, 100, 3, None, n_slot=2)
    with pytest.raises(ValueError, match="needs rack_size"):
        ops._check(lam_e, ell, home, rexp, 100, None, lam, n_slot=2)
    with pytest.raises(ValueError, match="health_weight"):
        ops._check(lam_e, ell, home, rexp, 100, 2, None, n_slot=2,
                   health_weight=torch.ones(3))
    for kw in ({"health_weight": torch.ones(4)}, {"probe_parallelism": 2}):
        plan = planner.solve_plan(lam, home, n_slot=2, rack_size=2, **kw)
        assert (plan.q.sum(dim=-1) == lam).all()


def test_config_validation_at_construction():
    from repro_torch.core.balancer import BalancerConfig
    from repro_torch.moe.gating import GatingConfig
    from repro_torch.moe.layer import MoEConfig

    def mk(**kw):
        base = dict(gating=GatingConfig(num_experts=8, top_k=2),
                    balancer=BalancerConfig(mode="ultraep", n_slot=2),
                    d_model=8, d_ff=8, ep_size=4, cap_pair=8, cap_slot=8)
        base.update(kw)
        return MoEConfig(**base)

    with pytest.raises(ValueError, match="dispatch_impl"):
        mk(dispatch_impl="bogus")
    with pytest.raises(ValueError, match="dispatch_mode"):
        mk(dispatch_mode="bogus")
    with pytest.raises(ValueError, match="hier_a2a"):
        mk(dispatch_mode="hier_a2a", dispatch_impl="reference")
    with pytest.raises(ValueError, match="racks"):
        mk(racks=3)
    assert mk(dispatch_mode="hier_a2a", racks=2).rack_size == 2
    assert mk(racks=1).rack_size is None


def test_hier_single_rank_equals_flat_fused():
    """At one rank ``hier_a2a`` is the flat layer (mirrors
    ``tests/test_hier.py::test_hier_single_rank_equals_flat_fused``)."""
    import dataclasses

    from repro_torch.moe.layer import moe_layer_local

    cfg = _config("a2a", 1, 0, ep=1)
    params = _params_one(cfg)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (T, D)).astype(np.float32))
    y_flat, _, _ = moe_layer_local(x, params, cfg)
    y_hier, _, _ = moe_layer_local(
        x, params, dataclasses.replace(cfg, dispatch_mode="hier_a2a"))
    assert torch.equal(y_flat, y_hier)


def test_wire_oracle_codec_matches_port_codec():
    from repro_torch.core.quantize import decode_wire, encode_wire
    from repro_torch.moe import wire_oracle

    x = np.random.default_rng(2).standard_normal((6, 5, 24)).astype(
        np.float32)
    x[1, 2] = 0.0
    for wire in ("int8", "bf16"):
        enc = encode_wire(torch.from_numpy(x), wire)
        ref = wire_oracle.np_encode_wire(x, wire)
        got = enc.view(torch.int16) if wire == "bf16" else enc
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(
            decode_wire(enc, wire, torch.float32).numpy(),
            wire_oracle.np_decode_wire(ref, wire))


# ------------------------------------ four gloo ranks beside JAX shard_map --


def _config(mode, racks, limit, ep=R, overlap=1, impl="fused", cap=CAP):
    from repro_torch.core.balancer import BalancerConfig
    from repro_torch.moe.gating import GatingConfig
    from repro_torch.moe.layer import MoEConfig

    return MoEConfig(
        gating=GatingConfig(num_experts=E, top_k=K, rack_limit=limit,
                            num_racks=RACKS if limit else 1),
        balancer=BalancerConfig(mode="ultraep", n_slot=2), d_model=D,
        d_ff=F, ep_size=ep, cap_pair=cap[0], cap_slot=cap[1],
        dispatch_mode=mode, racks=racks, distribute_chunks=2,
        overlap_chunks=overlap, dispatch_impl=impl)


def _params_one(cfg):
    from repro_torch.moe.layer import init_moe_params

    return init_moe_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")


def _inputs(path):
    """Seeded numpy inputs: R * T tokens whose routing leans on experts of
    rank 0 (so the plan replicates), the router and every expert; send
    buffers for the exchange checks."""
    rng = np.random.default_rng(0)

    def n(shape, fan_in):
        return (rng.standard_normal(shape) * fan_in ** -0.5).astype(np.float32)

    router = n((D, E), D)
    lean = rng.standard_normal(D).astype(np.float32)
    router[:, :3] += 0.6 * lean[:, None]
    x = rng.standard_normal((R * T, D)).astype(np.float32) + lean
    send = rng.standard_normal((R, R, 3, 8)).astype(np.float32)
    np.savez(path, x=x, router=router, w1=n((E, D, F), D),
             w3=n((E, D, F), D), w2=n((E, F, D), F), send=send)


def _worker(rank, world, port, inputs, out_dir):
    """One rank, with every plan the rank solves statically checked."""
    with plan_check.plan_verification():
        _rank_cases(rank, world, port, inputs, out_dir)


def _rank_cases(rank, world, port, inputs, out_dir):
    """One rank: the exchanges, then every layer case on the factored
    group and its flat twin on the flat group, and the gradients."""
    torch.set_num_threads(1)
    from repro_torch import convert
    from repro_torch.core.quantize import encode_wire
    from repro_torch.moe import stages
    from repro_torch.moe.layer import moe_layer_local
    from repro_torch.moe.permute import (
        two_hop_all_to_all,
        two_hop_all_to_all_async,
    )
    from repro_torch.parallel import collectives

    flat = collectives.init("gloo", world_size=world, rank=rank,
                            init_method=f"tcp://localhost:{port}",
                            timeout_s=120)
    hier = collectives.factor(RACKS)
    data = np.load(inputs)
    out = {}
    send = torch.from_numpy(data["send"][rank])
    out["wire/flat"] = collectives.all_to_all(flat, send).numpy()
    out["wire/hop"] = two_hop_all_to_all(send, hier).numpy()
    out["wire/hop_reverse"] = two_hop_all_to_all(send, hier,
                                                 reverse=True).numpy()
    out["wire/hop_async"] = two_hop_all_to_all_async(send, hier).wait().numpy()
    out["wire/hop_int8"] = two_hop_all_to_all(
        encode_wire(send, "int8"), hier).numpy()
    params = convert.moe_params(types.SimpleNamespace(
        router=data["router"], w1=data["w1"], w3=data["w3"], w2=data["w2"],
        shared_w1=None, shared_w3=None, shared_w2=None), n_slot=2,
        device="cpu", ep_rank=rank, ep_size=world)
    x_all = torch.from_numpy(data["x"])
    mine = x_all[rank * T:(rank + 1) * T]
    cases = {**{n: (c, hier) for n, c in LAYER_CASES.items()},
             **{f"{n}/flat": (c, flat) for n, c in FLAT_TWIN.items()}}
    for name, ((mode, racks, limit), group) in cases.items():
        cfg = _config(mode, racks, limit)
        x = x_all if mode == "replicated" else mine
        ctx = stages.make_stage_ctx(cfg, group)
        plan = stages.plan_stage(ctx, stages.gate_stage(ctx, x,
                                                        params.router)).plan
        y, _, st = moe_layer_local(x, params, cfg, axis_name=group)
        out[f"{name}/y"] = y.numpy()
        out[f"{name}/ids"] = stages.gate_stage(
            ctx, x, params.router).gate_out.expert_ids.numpy()
        out[f"{name}/drops"] = int(st.drops_dispatch + st.drops_slot)
        for f in PLAN_FIELDS:
            v = getattr(plan, f)
            if v is not None:
                out[f"{name}/plan/{f}"] = v.numpy()
        for f in ("tier_tokens", "tier_replicas", "tier_bytes",
                  "gate_tier_tokens", "gate_tier_bytes"):
            v = getattr(st, f)
            if v is not None:
                out[f"{name}/stats/{f}"] = v.numpy()
    for name, (mode, racks, limit) in TIGHT_CASES.items():
        cfg = _config(mode, racks, limit, cap=TIGHT_CAP)
        x = x_all if mode == "replicated" else mine
        y, _, st = moe_layer_local(x, params, cfg, axis_name=hier,
                                   resilience=stages.Resilience())
        out[f"{name}/y"] = y.numpy()
        out[f"{name}/drops"] = int(st.drops_dispatch + st.drops_slot)
        out[f"{name}/dropped_payload"] = int(st.dropped_payload_tokens)
    for name, group in (("hier", hier), ("hier/flat", flat)):
        mode, racks, limit = (LAYER_CASES if "/" not in name
                              else FLAT_TWIN)[name.split("/")[0]]
        cfg = _config(mode, racks, limit)
        params.requires_grad_(True)
        xg = mine.clone().requires_grad_(True)
        y, _, _ = moe_layer_local(xg, params, cfg, axis_name=group)
        (y ** 2).sum().backward()
        for g, t in zip(GRAD_NAMES, (xg, params.router, params.w1,
                                     params.w3, params.w2)):
            out[f"{name}/grad/{g}"] = t.grad.numpy().copy()
        params.requires_grad_(False)
        for t in params.parameters():
            t.grad = None
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
from repro.moe.gating import GatingConfig, gate, rack_copy_volumes
from repro.moe.layer import MoEConfig, MoEParams, moe_layer_local
RACKS, LANES, E, K, D, F, T = {RACKS}, {LANES}, {E}, {K}, {D}, {F}, {T}
R = RACKS * LANES
cases = {cases!r}
caps = {caps!r}
data = np.load({inputs!r})
x, router = jnp.asarray(data["x"]), jnp.asarray(data["router"])
ws = [jnp.asarray(data[k]) for k in ("w1", "w3", "w2")]
mesh = Mesh(np.array(jax.devices()).reshape(RACKS, LANES), ("rack", "model"))
axes = ("rack", "model")
home = ExpertLayout(E, R, 2).home()
out = {{}}
for name, (mode, racks, limit) in cases.items():
    gcfg = GatingConfig(num_experts=E, top_k=K, rack_limit=limit,
                        num_racks=RACKS if limit else 1)
    bcfg = jbal.BalancerConfig(mode="ultraep", n_slot=2)
    cfg = MoEConfig(gating=gcfg, balancer=bcfg, d_model=D, d_ff=F,
                    ep_size=R, cap_pair=caps[name][0],
                    cap_slot=caps[name][1],
                    dispatch_mode=mode, racks=racks, distribute_chunks=2)

    def run(x, router, w1, w3, w2):
        y, aux, st = moe_layer_local(x, MoEParams(router, w1, w3, w2), cfg,
                                     axis_name=axes)
        tiers = st.tier_tokens
        gt = (st.gate_tier_tokens if st.gate_tier_tokens is not None
              else jnp.zeros((3,), jnp.int32))
        return (y, (st.drops_dispatch + st.drops_slot)[None], tiers[None],
                st.tier_replicas[None], gt[None])

    x_spec = P(axes, None) if mode != "replicated" else P(None, None)
    w_spec = P(axes, None, None)
    f = shard_map(run, mesh=mesh,
                  in_specs=(x_spec, P(None, None), w_spec, w_spec, w_spec),
                  out_specs=(x_spec, P(axes), P(axes), P(axes), P(axes)))
    y, drops, tiers, treps, gtiers = jax.jit(f)(x, router, *ws)
    out[name + "/y"] = np.asarray(y)
    out[name + "/drops"] = np.asarray(drops)
    out[name + "/stats/tier_tokens"] = np.asarray(tiers)
    out[name + "/stats/tier_replicas"] = np.asarray(treps)
    out[name + "/stats/gate_tier_tokens"] = np.asarray(gtiers)
    if name == "hier":
        def loss_ep(*args):
            return (f(*args)[0] ** 2).sum()
        gs = jax.jit(jax.grad(loss_ep, argnums=(0, 1, 2, 3, 4)))(x, router,
                                                                 *ws)
        for g, a in zip({grad_names!r}, gs):
            out[name + "/grad/" + g] = np.asarray(a)
    gts = None
    if mode != "replicated":
        gos = [gate(x[r * T:(r + 1) * T], router, gcfg) for r in range(R)]
        lam = jnp.stack([go.counts for go in gos])
        gts = sum(rack_copy_volumes(go.expert_ids, home, num_ranks=R,
                                    rack_size=LANES, src_rank=r)
                  for r, go in enumerate(gos))
    else:
        counts = gate(x, router, gcfg).counts
        lam = (jax.nn.one_hot(home, R, dtype=jnp.int32) * counts[:, None]).T
    plan = jbal.solve(lam, home, bcfg, rack_size=LANES,
                      demand_tiebreak=gcfg.rack_binding,
                      gate_tier_tokens=gts)
    for fld in {fields!r}:
        v = getattr(plan, fld)
        if v is not None:
            out[name + "/plan/" + fld] = np.asarray(v)
np.savez({result!r}, **out)
print("DONE")
"""


@pytest.fixture(scope="module")
def hier_run(tmp_path_factory):
    """Both runs, side by side; returns (inputs, JAX results, each torch
    rank's results)."""
    from tests.helpers import run_multidevice

    tmp = tmp_path_factory.mktemp("hier")
    inputs = str(tmp / "inputs.npz")
    _inputs(inputs)
    jax_out = str(tmp / "jax.npz")
    caps = {**{n: CAP for n in LAYER_CASES},
            **{n: TIGHT_CAP for n in TIGHT_CASES}}
    code = _JAX.format(RACKS=RACKS, LANES=LANES, E=E, K=K, D=D, F=F, T=T,
                       cases={**LAYER_CASES, **TIGHT_CASES}, caps=caps,
                       inputs=inputs, fields=PLAN_FIELDS, result=jax_out,
                       grad_names=GRAD_NAMES)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    torch_cmd = [sys.executable, "-c",
                 f"from tests.test_torch_hier import _spawn; "
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
    """The group's y: the shards in rank order, or the replicated y (every
    rank's must be the same)."""
    cases = {**LAYER_CASES, **TIGHT_CASES}
    if cases[name.split("/")[0]][0] != "replicated":
        return np.concatenate([r[f"{name}/y"] for r in ranks])
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[f"{name}/y"], ranks[0][f"{name}/y"])
    return ranks[0][f"{name}/y"]


@pytest.mark.parametrize("reverse", ["hop", "hop_reverse", "hop_async"])
def test_two_hop_exchange_matches_oracle_and_flat(hier_run, reverse):
    from repro_torch.moe import wire_oracle

    data, _, ranks = hier_run
    oracle = wire_oracle.two_hop_wire(data["send"], RACKS,
                                      reverse=reverse == "hop_reverse")
    np.testing.assert_array_equal(oracle, wire_oracle.flat_wire(data["send"]))
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got[f"wire/{reverse}"], oracle[r])
        np.testing.assert_array_equal(got[f"wire/{reverse}"], got["wire/flat"])


def test_two_hop_exchange_carries_int8_rows(hier_run):
    from repro_torch.moe import wire_oracle

    data, _, ranks = hier_run
    enc = wire_oracle.np_encode_wire(data["send"], "int8")
    oracle = wire_oracle.two_hop_wire(enc, RACKS)
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["wire/hop_int8"], oracle[r])


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_factored_layer_matches_jax_shard_map(hier_run, name):
    _, jax_out, ranks = hier_run
    yj = jax_out[f"{name}/y"]
    np.testing.assert_allclose(_y(name, ranks), yj, rtol=0,
                               atol=1e-5 * np.abs(yj).max())
    np.testing.assert_array_equal(
        np.array([r[f"{name}/drops"] for r in ranks]), jax_out[f"{name}/drops"])
    assert jax_out[f"{name}/drops"].sum() == 0
    for f in ("tier_tokens", "tier_replicas", "gate_tier_tokens"):
        key = f"{name}/stats/{f}"
        for r, got in enumerate(ranks):
            if key in got:
                np.testing.assert_array_equal(got[key], jax_out[key][r],
                                              err_msg=key)
            else:
                assert f == "gate_tier_tokens" and not jax_out[key].any()


@pytest.mark.parametrize("name", list(TIGHT_CASES))
def test_factored_layer_drops_match_jax_at_a_tight_cap(hier_run, name):
    """At cap_slot 70 the factored layer drops items: per-rank drops equal
    to JAX's in every mode, y within 1e-5 of max|y|, and the payload
    screen's count (a Resilience with no fault) stays 0, apart from them."""
    _, jax_out, ranks = hier_run
    drops = np.array([r[f"{name}/drops"] for r in ranks])
    np.testing.assert_array_equal(drops, jax_out[f"{name}/drops"])
    assert drops.sum() > 0
    assert all(r[f"{name}/dropped_payload"] == 0 for r in ranks)
    yj = jax_out[f"{name}/y"]
    np.testing.assert_allclose(_y(name, ranks), yj, rtol=0,
                               atol=1e-5 * np.abs(yj).max())


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_factored_plan_tables_match_jax(hier_run, name):
    _, jax_out, ranks = hier_run
    for f in PLAN_FIELDS:
        key = f"{name}/plan/{f}"
        if key not in jax_out:
            assert all(key not in r for r in ranks), key
            continue
        for r in ranks:
            np.testing.assert_array_equal(r[key], jax_out[key], err_msg=key)
    assert (ranks[0][f"{name}/plan/x"] >= 0).any(), "no replica placed"


@pytest.mark.parametrize("name", ["hier", "hier_limit"])
def test_factored_layer_equals_flat_layer_bitwise(hier_run, name):
    _, _, ranks = hier_run
    np.testing.assert_array_equal(_y(name, ranks), _y(f"{name}/flat", ranks))


def test_factored_replicated_layer_matches_flat(hier_run):
    """The replicated mode merges the ranks' shares with a sum over lanes,
    then racks, in another order than the flat group's one sum: the
    tolerance of ``tests/test_hier.py::
    test_hier_replicated_mode_on_rack_mesh_inprocess``."""
    _, _, ranks = hier_run
    np.testing.assert_allclose(_y("hier_replicated", ranks),
                               _y("hier_replicated/flat", ranks), rtol=1e-6,
                               atol=1e-6)


def test_rack_limited_layer_keeps_each_token_in_one_rack(hier_run):
    _, _, ranks = hier_run
    for r in ranks:
        racks = r["hier_limit/ids"] // (E // RACKS)
        assert (racks == racks[:, :1]).all()
        gate_tiers = r["hier_limit/stats/gate_tier_tokens"]
        # At most one inter-rack copy a token, over the group's R T tokens.
        assert gate_tiers[2] <= R * T
        assert r["hier_limit/stats/tier_tokens"].sum() == R * T * K
        np.testing.assert_array_equal(
            r["hier_limit/stats/gate_tier_bytes"], gate_tiers * D * 4)
    assert ranks[0]["hier/stats/tier_tokens"].sum() == R * T * K


@pytest.mark.parametrize("grad", GRAD_NAMES)
def test_factored_layer_gradients_match_jax(hier_run, grad):
    _, jax_out, ranks = hier_run
    shards = [r[f"hier/grad/{grad}"] for r in ranks]
    flat = [r[f"hier/flat/grad/{grad}"] for r in ranks]
    # The router is replicated: the group's gradient is the ranks' sum.
    got = sum(shards) if grad == "router" else np.concatenate(shards)
    ref = sum(flat) if grad == "router" else np.concatenate(flat)
    np.testing.assert_allclose(got, jax_out[f"hier/grad/{grad}"], rtol=5e-4,
                               atol=5e-4)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert np.abs(got).max() > 0
