"""Port planner vs the JAX planner and the numpy oracle: exact plan tables.

The same Pareto-skewed numpy load matrices go through
``repro.core.planner.solve_plan`` (JAX, probe_parallelism=1),
``repro.core.ref_planner.solve`` (numpy) and the port's ``solve_plan`` /
``balancer.solve`` on the CPU; every integer table must be equal.
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
from repro_torch.core import balancer as tbal
from repro_torch.core import planner as tplan
from repro_torch.core.layout import ExpertLayout, physical_slot_of

E = 64
PLAN_FIELDS = ("u", "q", "x", "tau", "cum_q", "cum_u", "pre_max", "post_max",
               "hosted")


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


@pytest.mark.parametrize("kwargs", [
    {"health_weight": torch.ones(4)}, {"probe_parallelism": 2}])
def test_unported_arguments_raise(kwargs):
    lam = torch.from_numpy(_pareto_load(4, seed=0))
    with pytest.raises(ValueError):
        tplan.solve_plan(lam, torch.from_numpy(_home(4)), n_slot=2, **kwargs)
