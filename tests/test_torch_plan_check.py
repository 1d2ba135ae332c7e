"""The port's static plan checker (``repro_torch.analysis.plan_check``)
against the JAX package's, on the CPU.

* The port's plans from every balancer mode (none, ultraep at P 1 and 4,
  ultraep with health weights, eplb, eplb_plus, lplb), flat and at rack
  size 2, solved with the balancer's hook on: no error-severity violation
  in either checker, and the same violations (rule, severity, message)
  from both.
* The six corruptions of ``tests/test_analysis.py`` (a dropped token, a
  stale cumsum, a phantom instance, a misbound slot map, a wrong threshold,
  a wrong tier count) give the same violations in both checkers, the
  expected rule among the errors.
* ``verify_tier_bytes``, ``verify_chunking``, ``check_capacities``,
  ``hosted_matrix`` and ``verify_rack_limit`` (the routing-side invariant of
  the rack-limited gate, on the port's gate ids) give the same results.
* The balancer's hook: off by default; on, a solve whose plan breaks an
  invariant (an infeasible health-weighted solve that falls back to the
  home quota) raises ``PlanViolationError``, and the degradation ladder
  turns it into the last good plan, then the no-balance plan, with the
  same counters and plans as JAX's ladder under the same sequence.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import plan_check as jpc
from repro.core import balancer as jbal
from repro.moe import gating as jg
from repro.moe import stages as jstages
from repro_torch.analysis import plan_check as tpc
from repro_torch.analysis.violation import errors
from repro_torch.core import balancer as tbal
from repro_torch.core.topology import Topology
from repro_torch.moe import gating as tg
from repro_torch.moe import stages as tstages

R, E = 4, 16
FIELDS = ("u", "q", "x", "tau", "hosted", "pre_max", "post_max", "cum_q",
          "cum_u", "tier_tokens", "tier_replicas", "gate_tier_tokens")
# mode name -> (balancer mode, probe parallelism, health weights or None)
SOLVES = {"none": ("none", 1, None), "ultraep": ("ultraep", 1, None),
          "ultraep_p4": ("ultraep", 4, None),
          "ultraep_health": ("ultraep", 1, [1.0, 0.5, 1.0, 0.75]),
          "eplb": ("eplb", 1, None), "eplb_plus": ("eplb_plus", 1, None),
          "lplb": ("lplb", 1, None)}


def _skewed_lam(rng, R_=R, E_=E, items=256):
    """``tests/test_analysis.py``'s load: Zipf 1.2, ``items`` a rank."""
    w = 1.0 / np.arange(1, E_ + 1) ** 1.2
    lam = rng.poisson(items * w[None, :] / w.sum(), size=(R_, E_))
    lam = np.maximum(lam, 0)
    lam[:, 0] += items - lam.sum(axis=1)
    return lam.astype(np.int64)


def _home(R_=R, E_=E):
    return np.repeat(np.arange(R_, dtype=np.int64), E_ // R_)


def _solve(name, lam, rack_size=None):
    mode, P, w = SOLVES[name]
    cfg = tbal.BalancerConfig(mode=mode, n_slot=2, probe_parallelism=P)
    est = np.roll(lam.sum(0), E // 2).astype(np.float64)
    return tbal.solve(
        torch.from_numpy(lam), torch.from_numpy(_home(lam.shape[0],
                                                      lam.shape[1])), cfg,
        rack_size=rack_size,
        lam_e_est=torch.from_numpy(est) if mode == "eplb" else None,
        health_weight=None if w is None else torch.tensor(w))


def _numpy_plan(plan):
    """The plan's tables as numpy, in an object JAX's checker reads."""
    return types.SimpleNamespace(**{
        f: None if getattr(plan, f) is None else getattr(plan, f).numpy()
        for f in FIELDS})


def _topo(rack_size):
    return (Topology(racks=R // rack_size, ranks_per_rack=rack_size)
            if rack_size else Topology.flat(R))


def _jtopo(rack_size):
    from repro.core.topology import Topology as JTopology

    return (JTopology(racks=R // rack_size, ranks_per_rack=rack_size)
            if rack_size else JTopology.flat(R))


def _same(tv, jv):
    """Both checkers found the same violations, in the same order."""
    assert [str(v) for v in tv] == [str(v) for v in jv]


@pytest.fixture(autouse=True)
def _verify_plans():
    """The balancer's hook on for every solve here."""
    with tpc.plan_verification():
        yield


@pytest.mark.parametrize("rack_size", [None, 2], ids=["flat", "rack2"])
@pytest.mark.parametrize("name", list(SOLVES))
def test_port_plans_pass_both_checkers(name, rack_size):
    lam = _skewed_lam(np.random.default_rng(7))
    plan = _solve(name, lam, rack_size)
    rack_aware = None if name in ("eplb", "eplb_plus") else True
    w = SOLVES[name][2]
    kw = dict(lam=lam, home=_home(), rack_aware_mode=rack_aware,
              health_weight=None if w is None else np.asarray(w))
    tv = tpc.verify_plan(plan, _topo(rack_size), **kw)
    jv = jpc.verify_plan(_numpy_plan(plan), _jtopo(rack_size), **kw)
    assert not errors(tv), "\n".join(map(str, tv))
    _same(tv, jv)


def _corruptions(plan):
    """``tests/test_analysis.py``'s six corruptions of a valid plan: (name,
    the corrupted tables, the rule that must fire, with a topology)."""
    q = plan.q.clone()
    src, e = (q.sum(dim=2) > 0).nonzero()[0].tolist()
    q[src, e, int(q[src, e].argmax())] -= 1
    cum_q = plan.cum_q.clone()
    cum_q[0, 0, -1] += 1
    hosted = plan.hosted.clone()
    r, e = (~hosted).nonzero()[0].tolist()
    hosted[r, e] = True
    x = plan.x.clone()
    r = int((x >= 0).sum(dim=1).argmax())
    x[r] = x[r].flip(0)
    tt = plan.tier_tokens.clone()
    tt[0] += 1
    return [("token_loss", plan._replace(q=q), "token-conservation", False),
            ("stale_cumsum", plan._replace(cum_q=cum_q),
             "cumsum-consistency", False),
            ("phantom_instance", plan._replace(hosted=hosted),
             "replica-placement", False),
            ("misbound_slot_map", plan._replace(x=x), "replica-placement",
             False),
            ("wrong_threshold", plan._replace(post_max=plan.post_max + 1),
             "threshold-bounds", False),
            ("wrong_tier_accounting", plan._replace(tier_tokens=tt),
             "tier-accounting", True)]


@pytest.fixture
def valid_plan():
    lam = _skewed_lam(np.random.default_rng(0))
    return _solve("ultraep", lam, rack_size=2), lam


@pytest.mark.parametrize("which", range(6))
def test_corruptions_give_the_same_violations(valid_plan, which):
    plan, lam = valid_plan
    name, bad, rule, topo = _corruptions(plan)[which]
    tv = tpc.verify_plan(bad, _topo(2) if topo else None, lam=lam,
                         home=_home())
    jv = jpc.verify_plan(_numpy_plan(bad), _jtopo(2) if topo else None,
                         lam=lam, home=_home())
    assert any(v.rule == rule for v in errors(tv)), name
    _same(tv, jv)
    with pytest.raises(tpc.PlanViolationError, match=rule):
        tpc.assert_plan_valid(bad, _topo(2) if topo else None, lam=lam,
                              home=_home())


def test_tier_bytes_and_hosted_matrix_match_jax(valid_plan):
    plan, _ = valid_plan
    tt = plan.tier_tokens.numpy()
    for wire, width in (("none", 16 * 4), ("bf16", 16 * 2), ("int8", 20)):
        for tb in (tt * width, tt * 16, tt[:2] * width):
            _same(tpc.verify_tier_bytes(plan, torch.from_numpy(tb),
                                        d_model=16, wire_dtype=wire),
                  jpc.verify_tier_bytes(_numpy_plan(plan), tb, d_model=16,
                                        wire_dtype=wire))
    assert not tpc.verify_tier_bytes(plan, tt * 20, d_model=16,
                                     wire_dtype="int8")
    flat = _solve("ultraep", _skewed_lam(np.random.default_rng(1)))
    tv = tpc.verify_tier_bytes(flat, tt * 20, d_model=16, wire_dtype="int8")
    assert tv and not errors(tv)
    _same(tv, jpc.verify_tier_bytes(_numpy_plan(flat), tt * 20, d_model=16,
                                    wire_dtype="int8"))
    np.testing.assert_array_equal(tpc.hosted_matrix(plan),
                                  jpc.hosted_matrix(_numpy_plan(plan)))
    assert tpc.hosted_matrix(plan).shape == (E, R)


def test_chunking_and_capacities_match_jax(valid_plan):
    plan, lam = valid_plan
    rng = np.random.default_rng(3)
    cut = np.sort(rng.integers(0, lam[None] + 1, size=(2,) + lam.shape),
                  axis=0)
    chunk_lam = np.diff(np.concatenate([np.zeros((1,) + lam.shape, np.int64),
                                        cut, lam[None]]), axis=0)
    assert (chunk_lam >= 0).all() and (chunk_lam.sum(0) == lam).all()
    per_pair = plan.q.sum(dim=1)
    bad = chunk_lam.copy()
    bad[1, 0, 0] += 1
    for cl in (chunk_lam, bad, chunk_lam[:, :, :-1]):
        for caps in ({}, dict(cap_pair=8, cap_slot=4),
                     dict(cap_pair=10 ** 6, cap_slot=10 ** 6)):
            _same(tpc.verify_chunking(plan, torch.from_numpy(cl), **caps),
                  jpc.verify_chunking(_numpy_plan(plan), cl, **caps))
    assert not tpc.verify_chunking(plan, chunk_lam)
    for cap_pair in (int(per_pair.max()), int(per_pair.max()) - 1):
        for cap_slot in (None, int(plan.u.max()), int(plan.u.max()) - 1):
            tv = tpc.check_capacities(plan, cap_pair=cap_pair,
                                      cap_slot=cap_slot)
            _same(tv, jpc.check_capacities(_numpy_plan(plan),
                                           cap_pair=cap_pair,
                                           cap_slot=cap_slot))
            assert bool(tv) == (cap_pair < per_pair.max() or (
                cap_slot is not None and cap_slot < plan.u.max()))


@pytest.mark.parametrize("G,M", [(8, 2), (8, 8), (4, 1), (1, 0)])
def test_rack_limit_matches_jax_on_port_gate_ids(G, M):
    """The port's gate ids under a rack limit pass; the free ids against a
    binding limit, ids out of range, a geometry that is not rack-blocked
    and a limit of all racks that differs from free routing do not, in
    both checkers alike."""
    rng = np.random.default_rng(G + M)
    x = rng.standard_normal((64, 24)).astype(np.float32)
    w = (rng.standard_normal((24, 64)) * 24 ** -0.5).astype(np.float32)
    kw = dict(num_experts=64, top_k=6, score_fn="sigmoid")
    free = tg.gate(torch.from_numpy(x), torch.from_numpy(w),
                   tg.GatingConfig(**kw)).expert_ids
    limited = tg.gate(torch.from_numpy(x), torch.from_numpy(w),
                      tg.GatingConfig(**kw, num_racks=G, rack_limit=M)
                      ).expert_ids
    jlim = jg.gate(jnp.asarray(x), jnp.asarray(w),
                   jg.GatingConfig(**kw, num_racks=G, rack_limit=M)
                   ).expert_ids
    np.testing.assert_array_equal(limited.numpy(), np.asarray(jlim))
    rk = dict(rack_limit=M, num_racks=G, num_experts=64)
    cases = [(limited, None), (limited, free), (free, None),
             (free.flip(0), free), (free + 64, None), (free[:, 0], None)]
    for ids, ref in cases:
        tv = tpc.verify_rack_limit(ids, free_expert_ids=ref, **rk)
        jv = jpc.verify_rack_limit(
            ids.numpy(), free_expert_ids=None if ref is None else ref.numpy(),
            **rk)
        _same(tv, jv)
    assert not tpc.verify_rack_limit(limited, free_expert_ids=free, **rk)
    _same(tpc.verify_rack_limit(limited, rack_limit=1, num_racks=5,
                                num_experts=64),
          jpc.verify_rack_limit(limited.numpy(), rack_limit=1, num_racks=5,
                                num_experts=64))


def test_hook_is_off_by_default_and_raises_when_on(valid_plan):
    plan, lam = valid_plan
    bad = plan._replace(post_max=plan.post_max + 1)
    kw = dict(lam=torch.from_numpy(lam), home=torch.from_numpy(_home()),
              rack_size=2, mode="ultraep")
    with tpc.plan_verification(False):
        assert not tpc.verification_enabled()
        tpc.verify_solved(bad, **kw)              # off: nothing read
    assert tpc.verification_enabled()
    tpc.verify_solved(plan, **kw)
    with pytest.raises(tpc.PlanViolationError, match="threshold-bounds"):
        tpc.verify_solved(bad, **kw)


# The ladder's sequence: (ladder, health weights) a solve, on one shape.
# Weights with two zeros leave no feasible probe, so the health-weighted
# solve falls back to the home quota, which the hook rejects
# (health-quarantine): ladder "a" has a good plan cached by then, ladder
# "b" has none.
LADDER = [("a", [1.0, 1.0, 1.0, 1.0]), ("a", [1.0, 0.0, 0.0, 1.0]),
          ("a", [1.0, 1.0, 0.5, 1.0]), ("b", [1.0, 0.0, 0.0, 1.0])]
# (fallback_plans, last_good_reuses, no_balance_fallbacks) after each step.
LADDER_COUNTS = [(0, 0, 0), (1, 1, 0), (1, 1, 0), (1, 0, 1)]


def test_ladder_turns_plan_violations_into_fallbacks_as_jax():
    rng = np.random.default_rng(11)
    res = {n: (tstages.Resilience(), jstages.Resilience()) for n in "ab"}
    home = _home(R, 6 * R)
    for step, (name, w) in enumerate(LADDER):
        res_t, res_j = res[name]
        lam = _skewed_lam(rng, R, 6 * R)
        ht, hj = torch.tensor(w), jnp.asarray(w, jnp.float32)
        tplan = res_t.solve_with_ladder(
            lambda: tbal.solve(torch.from_numpy(lam), torch.from_numpy(home),
                               tbal.BalancerConfig(), health_weight=ht),
            torch.from_numpy(lam), torch.from_numpy(home), 2, None)
        with jpc.plan_verification():
            jplan = res_j.solve_with_ladder(
                lambda: jbal.solve(jnp.asarray(lam), jnp.asarray(home),
                                   jbal.BalancerConfig(), health_weight=hj),
                jnp.asarray(lam), jnp.asarray(home), 2, None)
        assert res_t.counters == res_j.counters, step
        for f in FIELDS[:9]:
            np.testing.assert_array_equal(getattr(tplan, f).numpy(),
                                          np.asarray(getattr(jplan, f)))
        c = res_t.counters
        assert (c["fallback_plans"], c["last_good_reuses"],
                c["no_balance_fallbacks"]) == LADDER_COUNTS[step]
        if 0.0 in w:                # the cached plan, or no-balance
            assert isinstance(res_t.last_error, tpc.PlanViolationError)
            assert "health-quarantine" in str(res_t.last_error)
