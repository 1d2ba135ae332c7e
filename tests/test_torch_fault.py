"""Degraded-fabric resilience in the port against the JAX package: the rank
health model (``core/health.py``), the fault injector (``fault/``), the
relay schedule and its simulator (``core/comm_plan.py``), and the
degradation ladder and payload screen of ``moe/stages.py``.

* Host-side numpy pieces: ``RankHealth`` sequences exactly equal, the
  injector's corrupted rows equal for the same (seed, step, kind, layer),
  ``build_relay_schedule``'s edges equal, ``simulate``'s stats within
  1e-12.
* The layer at R = 1 with a ``Resilience`` (``tests/test_fault.py``'s
  cases) against JAX's ``moe_layer_local``: y within 1e-4 (fp32), the
  counters and MoEStats's fault fields equal; the no-op bit-identical, a
  solve failure reusing the last good plan bitwise.
* The layer at R = 4: one run of four processes (spawn, gloo) holds every
  multi-rank case beside one JAX run under ``shard_map`` on four virtual
  devices.  Each case's plan (after the ladder) is equal on every rank and
  to JAX's; y within 1e-4 of max|y|, the fault counters equal per rank.
"""

import concurrent.futures
import dataclasses
import os
import socket
import subprocess
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import comm_plan as jcomm
from repro.core.balancer import BalancerConfig as JBalancerConfig
from repro.core.health import HealthConfig as JHealthConfig
from repro.core.health import RankHealth as JRankHealth
from repro.core.topology import Topology as JTopology
from repro.fault import injector as jinj
from repro.moe import stages as jstages
from repro.moe.gating import GatingConfig as JGatingConfig
from repro.moe.layer import MoEConfig as JMoEConfig
from repro.moe.layer import MoEParams as JMoEParams
from repro.moe.layer import moe_layer_local as j_moe_layer_local
from repro_torch.analysis import plan_check
from repro_torch import convert
from repro_torch.core import comm_plan as tcomm
from repro_torch.core.balancer import BalancerConfig
from repro_torch.core.health import HealthConfig, RankHealth
from repro_torch.core.topology import Topology
from repro_torch.fault import injector as tinj
from repro_torch.moe import stages as tstages
from repro_torch.moe.gating import GatingConfig
from repro_torch.moe.layer import MoEConfig, moe_layer_local

ROOT = Path(__file__).resolve().parents[1]
E1, K1, D1, F1, T1 = 8, 2, 16, 32, 64        # tests/test_fault.py's shapes


@pytest.fixture(autouse=True)
def _verify_plans():
    """Every plan the port's balancer solves here goes through its static
    check (``repro_torch.analysis.plan_check``), as the reference's
    tests/conftest.py does for the JAX package's."""
    with plan_check.plan_verification():
        yield


# ------------------------------------------------------ host-side pieces --


def _times(seed, R=6, steps=40):
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.9, 1.1, size=(steps, R))
    t[5:20, 2] *= 4.0            # a straggler that quarantines, then heals
    t[8, 4] = np.nan             # a lost measurement
    t[9, 0] = -1.0
    t[30:, 1] *= 2.0             # a slow rank
    return t


@pytest.mark.parametrize("seed", [0, 1])
def test_rank_health_sequences_equal(seed):
    cfg = dict(ewma_decay=0.7, quarantine_after=2, recover_after=4)
    th, jh = RankHealth(6, HealthConfig(**cfg)), JRankHealth(
        6, JHealthConfig(**cfg))
    for i, t in enumerate(_times(seed)):
        np.testing.assert_array_equal(th.observe(t), jh.observe(t))
        np.testing.assert_array_equal(th.weight, jh.weight)
        np.testing.assert_array_equal(th.quarantined, jh.quarantined)
        np.testing.assert_array_equal(th.planner_weights(),
                                      jh.planner_weights())
        if i == 25:
            th.quarantine(3)
            jh.quarantine(3)
        if i == 32:
            th.release(3)
            jh.release(3)
    assert th.num_quarantined == jh.num_quarantined
    with pytest.raises(ValueError):
        HealthConfig(ewma_decay=1.0)
    with pytest.raises(ValueError):
        th.observe(np.ones(5))


@pytest.mark.parametrize("kind", ["nan_payload", "transfer_corrupt"])
@pytest.mark.parametrize("step,layer", [(0, None), (3, 1), (7, 2)])
def test_injector_corrupts_the_same_rows(kind, step, layer):
    spec = dict(kind=kind, severity=0.3, start_step=0, layer=None)
    ti = tinj.FaultInjector([tinj.FaultSpec(**spec)], seed=5)
    ji = jinj.FaultInjector([jinj.FaultSpec(**spec)], seed=5)
    ti.advance(step)
    ji.advance(step)
    x = np.random.default_rng(step).standard_normal((3, 10, 4)).astype(
        np.float32)
    fn = "corrupt_payload" if kind == "nan_payload" else "corrupt_replicas"
    got = getattr(ti, fn)(torch.from_numpy(x), layer).numpy()
    want = np.asarray(getattr(ji, fn)(jnp.asarray(x), layer))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], x[~np.isnan(got)])
    assert ti.fired == ji.fired and ti.fired[kind] > 0
    ints = torch.ones((4, 4), dtype=torch.int8)
    assert getattr(ti, fn)(ints, layer) is ints


def test_injector_raises_as_the_reference():
    specs = [dict(kind="solve_fail", start_step=2, end_step=4),
             dict(kind="solve_timeout", layer=1),
             dict(kind="transfer_flaky", count=2),
             dict(kind="slow_rank", rank=1, severity=0.25)]
    ti = tinj.FaultInjector([tinj.FaultSpec(**s) for s in specs])
    ji = jinj.FaultInjector([jinj.FaultSpec(**s) for s in specs])

    def outcome(inj, call):
        try:
            call(inj)
            return None
        except Exception as e:                       # noqa: BLE001
            return type(e).__name__

    for step in range(5):
        ti.advance(step)
        ji.advance(step)
        for layer in (0, 1):
            for call in (lambda i: i.check_solve(layer),
                         lambda i: i.check_transfer(layer)):
                assert outcome(ti, call) == outcome(ji, call)
        np.testing.assert_array_equal(ti.rank_speed(3), ji.rank_speed(3))
    assert ti.fired == ji.fired
    assert issubclass(tinj.SolveTimeout, tinj.PlannerFault)
    with pytest.raises(ValueError):
        tinj.FaultSpec("meteor")


def _hosted(E, R, seed):
    rng = np.random.default_rng(seed)
    home = np.repeat(np.arange(R), E // R)
    hosted = rng.random((E, R)) < 0.15
    hosted[np.arange(E), home] = True
    hosted[0, :] = True                   # one wide fan-out
    return hosted, home


@pytest.mark.parametrize("racks", [1, 4])
@pytest.mark.parametrize("speed", [False, True])
def test_relay_schedule_and_simulation_match(racks, speed):
    E, R = 32, 16
    hosted, home = _hosted(E, R, racks)
    rank_speed = None
    if speed:
        rank_speed = np.ones(R)
        rank_speed[[3, 9]] = [0.5, 0.0]
    tt = Topology(racks=racks, ranks_per_rack=R // racks) if racks > 1 \
        else None
    jt = JTopology(racks=racks, ranks_per_rack=R // racks) if racks > 1 \
        else None
    ts = tcomm.build_relay_schedule(hosted, home, 64 << 20, topology=tt,
                                    rank_speed=rank_speed)
    js = jcomm.build_relay_schedule(hosted, home, 64 << 20, topology=jt,
                                    rank_speed=rank_speed)
    assert [dataclasses.astuple(e) for e in ts.edges] == [
        dataclasses.astuple(e) for e in js.edges]
    np.testing.assert_array_equal(ts.send_volume, js.send_volume)
    assert ts.max_send_volume == js.max_send_volume
    tm, tstat = tcomm.simulate(ts, num_ranks=R, link_bandwidth=100e9,
                               topology=tt, rank_speed=rank_speed,
                               return_stats=True)
    jm, jstat = jcomm.simulate(js, num_ranks=R, link_bandwidth=100e9,
                               topology=jt, rank_speed=rank_speed,
                               return_stats=True)
    assert abs(tm - jm) <= 1e-12
    np.testing.assert_allclose(tstat.edge_finish, jstat.edge_finish,
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(tstat.edge_is_inter, jstat.edge_is_inter)
    assert (tstat.intra_bytes, tstat.inter_bytes) == (jstat.intra_bytes,
                                                      jstat.inter_bytes)
    assert abs(tstat.last_intra - jstat.last_intra) <= 1e-12
    assert abs(tstat.last_inter - jstat.last_inter) <= 1e-12
    np.testing.assert_array_equal(
        tcomm.tier_wire_bytes([5, 6, 7], 64, "int8", 2),
        jcomm.tier_wire_bytes([5, 6, 7], 64, "int8", 2))


def test_resilience_relay_schedule_matches_jax():
    """``Resilience.relay_schedule``: a solved plan's replica broadcast
    schedule under the live rank speeds (rank 2 at half speed) equals the
    reference's, edge for edge."""
    from repro.core import balancer as jbal
    from repro_torch.core import balancer as tbal

    R, E = 8, 32
    lam = (np.random.default_rng(4).pareto(1.1, size=(R, E)) * 30).astype(
        np.int64)
    home = np.repeat(np.arange(R), E // R)
    t = np.ones(R)
    t[2] = 2.0
    scheds = []
    for bal, health, stages, arr in (
            (tbal, RankHealth, tstages, torch.from_numpy),
            (jbal, JRankHealth, jstages, jnp.asarray)):
        plan = bal.solve(arr(lam), arr(home), bal.BalancerConfig(n_slot=2))
        rh = health(R)
        rh.observe(t)
        res = stages.Resilience(health=rh)
        scheds.append(res.relay_schedule(plan, 64 << 20, arr(home),
                                         relay_threshold=2))
    ts, js = scheds
    assert len(ts.edges) > 0
    assert [dataclasses.astuple(e) for e in ts.edges] == [
        dataclasses.astuple(e) for e in js.edges]
    np.testing.assert_array_equal(ts.send_volume, js.send_volume)


def test_screen_payload_matches_jax():
    x = np.random.default_rng(0).standard_normal((6, 4)).astype(np.float32)
    x[2, 1] = np.nan
    x[5, 0] = np.inf
    x[4, 3] = np.nan
    valid = np.array([1, 1, 1, 1, 0, 1], bool)
    txs, tv, tn = tstages.screen_payload(torch.from_numpy(x),
                                         torch.from_numpy(valid))
    jxs, jv, jn = jstages.screen_payload(jnp.asarray(x), jnp.asarray(valid))
    np.testing.assert_array_equal(txs.numpy(), np.asarray(jxs))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert int(tn) == int(jn) == 2
    ints = torch.ones((4, 4), dtype=torch.int8)
    out, v2, n = tstages.screen_payload(ints, torch.ones(4, dtype=bool))
    assert out is ints and int(n) == 0


# ------------------------------------------------- the layer at R = 1 --


def _single_rank():
    rng = np.random.default_rng(0)

    def n(shape, fan_in):
        return (rng.standard_normal(shape) * fan_in ** -0.5).astype(np.float32)

    p = JMoEParams(n((D1, E1), D1), n((E1, D1, F1), D1), n((E1, D1, F1), D1),
                   n((E1, F1, D1), F1))
    x = rng.standard_normal((T1, D1)).astype(np.float32)
    kw = dict(d_model=D1, d_ff=F1, ep_size=1, cap_pair=T1 * K1,
              cap_slot=T1 * K1)
    jcfg = JMoEConfig(gating=JGatingConfig(num_experts=E1, top_k=K1),
                      balancer=JBalancerConfig(n_slot=2), **kw)
    tcfg = MoEConfig(gating=GatingConfig(num_experts=E1, top_k=K1),
                     balancer=BalancerConfig(n_slot=2), **kw)
    jp = JMoEParams(*(None if a is None else jnp.asarray(a) for a in p))
    return x, jp, convert.moe_params(p, n_slot=2, device="cpu"), jcfg, tcfg


# name: (ResilienceConfig kwargs, fault specs (kind, kwargs), seed, steps
# run before the checked call, health)
SCENARIOS = {
    "noop": ({}, [], 0, 0, False),
    "solve_fail_last_good": ({}, [("solve_fail", dict(start_step=1))], 0, 1,
                             False),
    "double_failure_no_balance": ({}, [("solve_fail", {})], 0, 0, False),
    "nan_payload": ({}, [("nan_payload", dict(severity=0.25))], 3, 0, False),
    "transfer_flaky": (dict(max_transfer_retries=2),
                       [("transfer_flaky", dict(count=2))], 0, 0, False),
    "transfer_exhaustion": (dict(max_transfer_retries=1),
                            [("transfer_flaky", dict(count=5))], 0, 0, False),
    "solve_deadline": (dict(solve_deadline_s=0.0), [], 0, 0, False),
    "quarantined_stat": ({}, [], 0, 0, True),
}


def _resilience(pkg, scenario):
    rcfg, specs, seed, _, health = SCENARIOS[scenario]
    inj = None
    if specs:
        inj = pkg.inj.FaultInjector([pkg.inj.FaultSpec(k, **kw)
                                     for k, kw in specs], seed=seed)
    return pkg.stages.Resilience(pkg.stages.ResilienceConfig(**rcfg),
                                 injector=inj,
                                 health=pkg.health(1) if health else None)


TORCH = types.SimpleNamespace(inj=tinj, stages=tstages, health=RankHealth)
JAX = types.SimpleNamespace(inj=jinj, stages=jstages, health=JRankHealth)


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_layer_resilience_matches_jax(scenario):
    x, jp, tp, jcfg, tcfg = _single_rank()
    warm = SCENARIOS[scenario][3]
    y_clean, _, _ = moe_layer_local(torch.from_numpy(x), tp, tcfg)
    outs = {}
    for tag, pkg in (("torch", TORCH), ("jax", JAX)):
        res = _resilience(pkg, scenario)
        for step in range(warm + 1):
            if res.injector is not None:
                res.injector.advance(step)
            if tag == "torch":
                y, aux, st = moe_layer_local(torch.from_numpy(x), tp, tcfg,
                                             resilience=res)
                y = y.numpy()
            else:
                y, aux, st = j_moe_layer_local(jnp.asarray(x), jp, jcfg,
                                               axis_name=None, resilience=res)
                y = np.asarray(y)
        outs[tag] = (y, st, res)
    (yt, st, rt), (yj, sj, rj) = outs["torch"], outs["jax"]
    np.testing.assert_allclose(yt, yj, rtol=1e-4, atol=1e-4)
    assert np.isfinite(yt).all()
    assert rt.counters == rj.counters
    for f in ("fallback_plans", "dropped_payload_tokens", "quarantined_ranks",
              "drops_dispatch", "drops_slot", "post_max"):
        assert int(getattr(st, f)) == int(getattr(sj, f)), f
    if rt.injector is not None:
        assert rt.injector.fired == rj.injector.fired
    c = rt.counters
    if scenario == "noop":
        assert np.array_equal(yt, y_clean.numpy())
        assert int(st.fallback_plans) == int(st.dropped_payload_tokens) == 0
    elif scenario == "solve_fail_last_good":
        assert c["last_good_reuses"] == 1 and int(st.fallback_plans) == 1
        assert np.array_equal(yt, y_clean.numpy())
    elif scenario == "double_failure_no_balance":
        assert c["no_balance_fallbacks"] == 1 and int(st.fallback_plans) == 1
    elif scenario == "nan_payload":
        assert rt.injector.fired["nan_payload"] > 0
        assert int(st.dropped_payload_tokens) > 0
        assert int(st.drops_dispatch) == int(st.drops_slot) == 0
    elif scenario == "transfer_flaky":
        assert c["transfer_retries"] == 2 and c["transfer_fallbacks"] == 0
        assert np.array_equal(yt, y_clean.numpy())
    elif scenario == "transfer_exhaustion":
        assert c["transfer_fallbacks"] == 1 and int(st.fallback_plans) >= 1
    elif scenario == "solve_deadline":
        assert int(st.fallback_plans) == 1
    else:
        assert int(st.quarantined_ranks) == 0


def test_last_good_plan_is_not_written_in_place():
    """The cached plan's tensors are fresh: a later solve on other load
    leaves them as they were."""
    x, _, tp, _, tcfg = _single_rank()
    res = tstages.Resilience()
    moe_layer_local(torch.from_numpy(x), tp, tcfg, resilience=res)
    cached = res.last_good
    before = [t.clone() for t in (cached.u, cached.q, cached.x)]
    moe_layer_local(torch.from_numpy(-3 * x), tp, tcfg,
                    resilience=tstages.Resilience())
    for a, b in zip(before, (cached.u, cached.q, cached.x)):
        assert torch.equal(a, b)


# ------------------------------------------------- the layer at R = 4 --

R, E, K, D, F, T = 4, 16, 4, 32, 48, 64
# name: (fault specs (kind, kwargs), ResilienceConfig kwargs, health: None,
# or (kind, rank) with kind "slow" (half speed) or "quarantine")
EP_CASES = {
    "clean": ([], {}, None),
    "health_slow_rank1": ([], {}, ("slow", 1)),
    "health_quarantine_rank2": ([], {}, ("quarantine", 2)),
    "solve_fail": ([("solve_fail", {})], {}, None),
    "nan_payload": ([("nan_payload", dict(severity=0.2))], {}, None),
    "transfer_flaky": ([("transfer_flaky", dict(count=2))],
                       dict(max_transfer_retries=2), None),
    "transfer_exhaustion": ([("transfer_flaky", dict(count=5))],
                            dict(max_transfer_retries=1), None),
}
EP_PLAN_FIELDS = ("u", "q", "x", "tau", "hosted", "cum_q", "cum_u")
EP_STATS = ("fallback_plans", "dropped_payload_tokens", "quarantined_ranks",
            "drops", "post_max")


def _ep_inputs(path):
    rng = np.random.default_rng(0)

    def n(shape, fan_in):
        return (rng.standard_normal(shape) * fan_in ** -0.5).astype(np.float32)

    router = n((D, E), D)
    lean = rng.standard_normal(D).astype(np.float32)
    router[:, :3] += 0.6 * lean[:, None]
    x = rng.standard_normal((R * T, D)).astype(np.float32) + lean
    np.savez(path, x=x, router=router, w1=n((E, D, F), D),
             w3=n((E, D, F), D), w2=n((E, F, D), F))


def _ep_resilience(pkg, name):
    specs, rcfg, health = EP_CASES[name]
    if not specs and not rcfg and health is None:
        return None
    inj = None
    if specs:
        inj = pkg.inj.FaultInjector([pkg.inj.FaultSpec(k, **kw)
                                     for k, kw in specs], seed=7)
        inj.advance(0)
    rh = None
    if health is not None:
        kind, rank = health
        rh = pkg.health(R)
        if kind == "slow":
            t = np.ones(R)
            t[rank] = 2.0
            rh.observe(t)            # weight 0.5, flagged once, not held
        else:
            rh.quarantine(rank)
    return pkg.stages.Resilience(pkg.stages.ResilienceConfig(**rcfg),
                                 injector=inj, health=rh)


def _ep_worker(rank, world, port, inputs, out_dir):
    torch.set_num_threads(1)
    from repro_torch.parallel import collectives

    group = collectives.init("gloo", world_size=world, rank=rank,
                             init_method=f"tcp://localhost:{port}",
                             timeout_s=120)
    data = np.load(inputs)
    params = convert.moe_params(types.SimpleNamespace(
        router=data["router"], w1=data["w1"], w3=data["w3"], w2=data["w2"],
        shared_w1=None, shared_w3=None, shared_w2=None), n_slot=2,
        device="cpu", ep_rank=rank, ep_size=world)
    cfg = MoEConfig(gating=GatingConfig(num_experts=E, top_k=K),
                    balancer=BalancerConfig(n_slot=2), d_model=D, d_ff=F,
                    ep_size=R, cap_pair=T * K, cap_slot=R * T * K)
    x = torch.from_numpy(data["x"])[rank * T:(rank + 1) * T]
    out = {}
    for name in EP_CASES:
        # The plan each rank runs after the ladder, by the stages.
        res = _ep_resilience(TORCH, name)
        ctx = tstages.make_stage_ctx(cfg, group)
        gs = tstages.gate_stage(ctx, x, params.router)
        ps = tstages.plan_stage(ctx, gs, resilience=res)
        ps, _ = tstages._distribute_with_ladder(ctx, params, gs, ps, res)
        for f in EP_PLAN_FIELDS:
            out[f"{name}/plan/{f}"] = getattr(ps.plan, f).numpy()
        res = _ep_resilience(TORCH, name)
        y, _, st = moe_layer_local(x, params, cfg, axis_name=group,
                                   resilience=res)
        out[f"{name}/y"] = y.numpy()
        out[f"{name}/drops"] = int(st.drops_dispatch + st.drops_slot)
        out[f"{name}/post_max"] = int(st.post_max)
        if res is not None:
            for f in EP_STATS[:3]:
                out[f"{name}/{f}"] = int(getattr(st, f))
            out[f"{name}/counters"] = np.array(list(res.counters.values()))
    np.savez(os.path.join(out_dir, f"torch_rank{rank}.npz"), **out)
    collectives.destroy()


def _ep_spawn(inputs, out_dir):
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_ep_worker, args=(R, port, inputs, out_dir), nprocs=R,
             join=True)


_JAX = r"""
import types
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.core import balancer as jbal
from repro.core.health import RankHealth
from repro.core.layout import ExpertLayout
from repro.fault import injector as inj
from repro.models.transformer import shard_map_compat as shard_map
from repro.moe import stages
from repro.moe.gating import GatingConfig, gate
from repro.moe.layer import MoEConfig, MoEParams, moe_layer_local
from tests.test_torch_fault import EP_CASES, EP_PLAN_FIELDS, _ep_resilience
R, E, K, D, F, T = {R}, {E}, {K}, {D}, {F}, {T}
pkg = types.SimpleNamespace(inj=inj, stages=stages, health=RankHealth)
data = np.load({inputs!r})
x, router = jnp.asarray(data["x"]), jnp.asarray(data["router"])
ws = [jnp.asarray(data[k]) for k in ("w1", "w3", "w2")]
mesh = Mesh(np.array(jax.devices()).reshape(R), ("model",))
home = ExpertLayout(E, R, 2).home()
gcfg = GatingConfig(num_experts=E, top_k=K)
cfg = MoEConfig(gating=gcfg, balancer=jbal.BalancerConfig(n_slot=2),
                d_model=D, d_ff=F, ep_size=R, cap_pair=T * K,
                cap_slot=R * T * K)
lam = jnp.stack([gate(x[r * T:(r + 1) * T], router, gcfg).counts
                 for r in range(R)])
out = {{}}
for name in EP_CASES:
    res = _ep_resilience(pkg, name)

    def run(x, router, w1, w3, w2):
        y, aux, st = moe_layer_local(x, MoEParams(router, w1, w3, w2), cfg,
                                     axis_name="model", resilience=res)
        extra = [jnp.zeros((), jnp.int32)] * 3
        if res is not None:
            extra = [st.fallback_plans, st.dropped_payload_tokens,
                     st.quarantined_ranks]
        return (y, (st.drops_dispatch + st.drops_slot)[None],
                st.post_max[None], *(e[None] for e in extra))

    xs, w_spec = P("model", None), P("model", None, None)
    f = shard_map(run, mesh=mesh,
                  in_specs=(xs, P(None, None), w_spec, w_spec, w_spec),
                  out_specs=(xs,) + (P("model"),) * 5)
    y, drops, post, fb, dp, qr = jax.jit(f)(x, router, *ws)
    out[name + "/y"] = np.asarray(y)
    for k, v in (("drops", drops), ("post_max", post),
                 ("fallback_plans", fb), ("dropped_payload_tokens", dp),
                 ("quarantined_ranks", qr)):
        out[name + "/" + k] = np.asarray(v)
    if res is not None:
        out[name + "/counters"] = np.array(list(res.counters.values()))
    # The plan the ladder picks: the solve (health-weighted), or the
    # no-balance plan after a solve failure or an exhausted transfer.
    specs, _, health = EP_CASES[name]
    kinds = [k for k, _ in specs]
    if "solve_fail" in kinds or name == "transfer_exhaustion":
        plan = jbal.no_balance_plan(lam, home, 2)
    else:
        hw = None
        if res is not None and res.health is not None:
            hw = jnp.asarray(res.health.planner_weights(), jnp.float32)
        plan = jbal.solve(lam, home, cfg.balancer, health_weight=hw)
    for fld in EP_PLAN_FIELDS:
        out[name + "/plan/" + fld] = np.asarray(getattr(plan, fld))
np.savez({result!r}, **out)
print("DONE")
"""


@pytest.fixture(scope="module")
def ep_run(tmp_path_factory):
    from tests.helpers import run_multidevice

    tmp = tmp_path_factory.mktemp("ep_fault")
    inputs = str(tmp / "inputs.npz")
    _ep_inputs(inputs)
    jax_out = str(tmp / "jax.npz")
    code = ("import sys; sys.path.insert(0, " + repr(str(ROOT)) + ")\n"
            + _JAX.format(R=R, E=E, K=K, D=D, F=F, T=T, inputs=inputs,
                          result=jax_out))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    torch_cmd = [sys.executable, "-c",
                 f"from tests.test_torch_fault import _ep_spawn; "
                 f"_ep_spawn({inputs!r}, {str(tmp)!r})"]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        jax_job = pool.submit(run_multidevice, code, R, 300)
        torch_job = pool.submit(subprocess.run, torch_cmd, cwd=ROOT, env=env,
                                capture_output=True, text=True, timeout=300)
        assert "DONE" in jax_job.result()
        proc = torch_job.result()
    assert proc.returncode == 0, proc.stderr[-4000:]
    ranks = [dict(np.load(tmp / f"torch_rank{r}.npz")) for r in range(R)]
    return dict(np.load(jax_out)), ranks


@pytest.mark.parametrize("name", list(EP_CASES))
def test_ep_plans_equal_on_every_rank_and_to_jax(ep_run, name):
    jax_out, ranks = ep_run
    for f in EP_PLAN_FIELDS:
        for r in ranks:
            np.testing.assert_array_equal(r[f"{name}/plan/{f}"],
                                          jax_out[f"{name}/plan/{f}"],
                                          err_msg=f)
    u = ranks[0][f"{name}/plan/u"]
    if name == "health_quarantine_rank2":
        assert u[:, 2].sum() == 0          # the quarantined rank drains
    if name == "health_slow_rank1":
        clean = ranks[0]["clean/plan/u"]
        assert u[:, 1].sum() < clean[:, 1].sum()


@pytest.mark.parametrize("name", list(EP_CASES))
def test_ep_resilient_layer_matches_jax(ep_run, name):
    jax_out, ranks = ep_run
    yj = jax_out[f"{name}/y"]
    yt = np.concatenate([r[f"{name}/y"] for r in ranks])
    assert np.isfinite(yt).all()
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-4 * np.abs(yj).max())
    stats = EP_STATS if EP_CASES[name] != ([], {}, None) else EP_STATS[3:]
    for f in stats:
        np.testing.assert_array_equal(
            np.array([r[f"{name}/{f}"] for r in ranks]),
            jax_out[f"{name}/{f}"], err_msg=f)
    if f"{name}/counters" in jax_out:
        for r in ranks:
            np.testing.assert_array_equal(r[f"{name}/counters"],
                                          jax_out[f"{name}/counters"])
    if name in ("transfer_flaky", "solve_fail", "nan_payload"):
        assert all(r[f"{name}/drops"] == 0 for r in ranks)
    if name == "transfer_flaky":
        np.testing.assert_array_equal(
            yt, np.concatenate([r["clean/y"] for r in ranks]))
    if name == "nan_payload":
        assert all(r[f"{name}/dropped_payload_tokens"] > 0 for r in ranks)
