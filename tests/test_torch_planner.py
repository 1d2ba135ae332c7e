"""Port planner vs the JAX planner and the numpy oracle: exact plan tables.

The same Pareto-skewed numpy load matrices go through
``repro.core.planner.solve_plan`` (JAX), ``repro.core.ref_planner.solve``
(numpy, probe_parallelism=1 without health weights) and the port's
``solve_plan`` / ``balancer.solve`` on the CPU; every integer table must be
equal, with health weights and k-ary probing too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import balancer as jbal
from repro.core import planner as jplan
from repro.core import ref_planner
from repro.core.layout import ExpertLayout as JLayout
from repro.core.layout import physical_slot_of as j_physical_slot_of
from repro_torch.analysis import plan_check
from repro_torch.core import balancer as tbal
from repro_torch.core import planner as tplan
from repro_torch.core.layout import ExpertLayout, physical_slot_of

E = 64
PLAN_FIELDS = ("u", "q", "x", "tau", "cum_q", "cum_u", "pre_max", "post_max",
               "hosted")


@pytest.fixture(autouse=True)
def _verify_plans():
    """Every plan the port's balancer solves here goes through its static
    check (``repro_torch.analysis.plan_check``), as the reference's
    tests/conftest.py does for the JAX package's."""
    with plan_check.plan_verification():
        yield


def _pareto_load(R, seed, scale=30):
    rng = np.random.default_rng(seed)
    return (rng.pareto(1.2, size=(R, E)) * scale).astype(np.int32)


def _home(R):
    return np.repeat(np.arange(R), E // R).astype(np.int32)


def _assert_plan_equal(jp, tp):
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jp, f)),
                                      getattr(tp, f).numpy(), err_msg=f)


@pytest.mark.parametrize("R", [1, 4, 8, 16])
@pytest.mark.parametrize("seed", [0, 1])
def test_solve_plan_matches_jax_and_oracle(R, seed):
    lam = _pareto_load(R, seed)
    home = _home(R)
    jp = jplan.solve_plan(jnp.asarray(lam), jnp.asarray(home), n_slot=2,
                          u_min=8)
    tp = tplan.solve_plan(torch.from_numpy(lam), torch.from_numpy(home),
                          n_slot=2, u_min=8)
    _assert_plan_equal(jp, tp)
    ref = ref_planner.solve(lam, home, n_slot=2, u_min=8)
    np.testing.assert_array_equal(ref.u, tp.u.numpy())
    np.testing.assert_array_equal(ref.q, tp.q.numpy())
    np.testing.assert_array_equal(ref.x, tp.x.numpy())
    assert ref.tau == int(tp.tau)
    # Marginals are exact.
    assert (tp.q.sum(dim=-1) == torch.from_numpy(lam).long()).all()
    assert (tp.q.sum(dim=0) == tp.u).all()


@pytest.mark.parametrize("R", [1, 4, 16])
@pytest.mark.parametrize("mode", ["none", "ultraep", "ideal"])
def test_balancer_solve_matches_jax(R, mode):
    lam = _pareto_load(R, seed=3)
    home = _home(R)
    jp = jbal.solve(jnp.asarray(lam), jnp.asarray(home),
                    jbal.BalancerConfig(mode=mode, n_slot=2))
    tp = tbal.solve(torch.from_numpy(lam), torch.from_numpy(home),
                    tbal.BalancerConfig(mode=mode, n_slot=2))
    _assert_plan_equal(jp, tp)


def test_single_rank_solve_is_immediate():
    """At R == 1 the bisection interval is empty: no replicas, tau = load."""
    lam = _pareto_load(1, seed=5)
    tp = tplan.solve_plan(torch.from_numpy(lam), torch.zeros(E, dtype=torch.long),
                          n_slot=2)
    assert (tp.x == -1).all()
    assert int(tp.tau) == int(tp.pre_max) == int(tp.post_max) == lam.sum()


@pytest.mark.parametrize("R", [1, 4, 8])
def test_layout_and_lookups_match_jax(R):
    lam = _pareto_load(R, seed=7)
    home = _home(R)
    jp = jplan.solve_plan(jnp.asarray(lam), jnp.asarray(home), n_slot=2)
    jslot = j_physical_slot_of(JLayout(E, R, 2), jp.x)
    tslot = physical_slot_of(ExpertLayout(E, R, 2),
                             torch.from_numpy(np.array(jp.x)))
    np.testing.assert_array_equal(np.asarray(jslot), tslot.numpy())
    np.testing.assert_array_equal(
        np.asarray(JLayout(E, R, 2).home()),
        ExpertLayout(E, R, 2).home(device="cpu").numpy())

    ids = np.random.default_rng(R).integers(0, E, size=300).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jplan.occurrence_index(jnp.asarray(ids))),
        tplan.occurrence_index(torch.from_numpy(ids).long()).numpy())
    for r in range(R):
        jt = jplan.token_targets(jnp.asarray(ids), jp.q[r])
        tt = tplan.token_targets(torch.from_numpy(ids).long(),
                                 torch.from_numpy(np.array(jp.q[r])))
        np.testing.assert_array_equal(np.asarray(jt), tt.numpy())


# Health weights (R = 8): exact sums (1, 0.5, 0.25, 0), arbitrary ones, one
# quarantined rank, all zero (uniform fallback), a single slow rank.
WEIGHTS = {
    "exact": np.array([1, 0.5, 0.25, 0] * 2, dtype=np.float64),
    "arbitrary": np.random.default_rng(9).uniform(0.1, 1.0, 8),
    "quarantine": np.array([1, 1, 0, 1, 1, 1, 1, 1], dtype=np.float64),
    "all_zero": np.zeros(8),
    "half_rank1": np.array([1, 0.5, 1, 1, 1, 1, 1, 1], dtype=np.float64),
}


@pytest.mark.parametrize("rack_size", [None, 2])
@pytest.mark.parametrize("weights", list(WEIGHTS))
def test_health_weighted_solve_matches_jax(weights, rack_size):
    """``health_weight``: the whole plan equal to JAX's, flat and rack-aware;
    with one rank quarantined the solve is feasible and that rank drains
    to zero (where no probe is feasible, as with two zero weights here, the
    plan is the home quota, as in JAX)."""
    R = 8
    lam = _pareto_load(R, seed=11)
    home = _home(R)
    w = WEIGHTS[weights]
    jp = jplan.solve_plan(jnp.asarray(lam), jnp.asarray(home), n_slot=2,
                          health_weight=jnp.asarray(w, jnp.float32),
                          rack_size=rack_size)
    tp = tplan.solve_plan(torch.from_numpy(lam), torch.from_numpy(home),
                          n_slot=2, health_weight=torch.from_numpy(w),
                          rack_size=rack_size)
    _assert_plan_equal(jp, tp)
    if weights == "quarantine":
        assert int(tp.u.sum(dim=0)[2]) == 0


@pytest.mark.parametrize("rack_size", [None, 4])
@pytest.mark.parametrize("P", [2, 4, 8])
def test_kary_solve_matches_jax(P, rack_size):
    """``probe_parallelism`` P: the whole plan equal to JAX's k-ary solve,
    also with health weights."""
    R = 16
    for seed in (0, 1):
        lam = _pareto_load(R, seed)
        home = _home(R)
        kw = dict(n_slot=2, u_min=4, probe_parallelism=P, rack_size=rack_size)
        jp = jplan.solve_plan(jnp.asarray(lam), jnp.asarray(home), **kw)
        tp = tplan.solve_plan(torch.from_numpy(lam), torch.from_numpy(home),
                              **kw)
        _assert_plan_equal(jp, tp)
    w = np.tile(WEIGHTS["half_rank1"], 2)
    jp = jplan.solve_plan(jnp.asarray(lam), jnp.asarray(home),
                          health_weight=jnp.asarray(w, jnp.float32), **kw)
    tp = tplan.solve_plan(torch.from_numpy(lam), torch.from_numpy(home),
                          health_weight=torch.from_numpy(w), **kw)
    _assert_plan_equal(jp, tp)


def test_kary_stats_count_batches():
    """The plain solve's statistics at P = 8 and 12: probes come in batches
    of the kernel's warps, and the critical path is at most the steps."""
    from repro_torch.kernels.plan_solve import ops

    R = 8
    lam = torch.from_numpy(_pareto_load(R, seed=2)).long()
    home = torch.from_numpy(_home(R)).long()
    lam_e = lam.sum(dim=0)
    args = (lam_e, tplan._rank_load(lam_e, home, R), home,
            tplan._expert_order(lam_e, home, R))
    for P in (1, 8, 12):
        stats = torch.zeros(3, dtype=torch.int32)
        ops.plan_solve(*args, n_slot=2, u_min=1, max_replicas_per_expert=R,
                       load_bound=None, stats=stats, probe_parallelism=P)
        probes, steps, crit = stats.tolist()
        assert crit <= steps and probes >= 1
        if P == 1:
            assert crit == steps
        else:
            assert probes % min(P, ops.PROBE_WARPS) == 0 or P > 8
