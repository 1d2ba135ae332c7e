"""The paper's baselines and balance metrics in the port against the JAX
package: EPLB / EPLB+ (``core/eplb.py``, the placement through the plain
version of ``kernels/eplb_place`` on the CPU), LPLB (``core/lplb.py``),
``balancer.solve`` in every mode, flat and rack-aware, ``metrics.report``,
and the plan solve's k-ary probing.

The same numpy loads (``tests/test_baselines.py``'s Pareto case, and Zipf
1.0 loads of 4096 tokens x top-8 a rank at E 128 and E 256, R 64) go
through both packages.  Integer results (hosted, q, u, every plan table,
the tier volumes) must be equal; the metrics are numpy on both sides and
agree within 1e-12.  The EPLB placement's f32 estimate is summed by expert
id in the port; XLA's order is not documented, so these inputs are the
check that the two agree.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import balancer as jbal
from repro.core import eplb as jeplb
from repro.core import lplb as jlplb
from repro.core import metrics as jmetrics
from repro.core import planner as jplan
from repro_torch.analysis import plan_check
from repro_torch.core import balancer as tbal
from repro_torch.core import eplb as teplb
from repro_torch.core import lplb as tlplb
from repro_torch.core import metrics as tmetrics
from repro_torch.core import planner as tplan
from repro_torch.kernels.eplb_place import ops as eplb_ops

PLAN_FIELDS = ("u", "q", "x", "tau", "hosted", "cum_q", "cum_u", "pre_max",
               "post_max")
MODES = ("none", "ultraep", "eplb_plus", "eplb", "lplb", "ideal")


@pytest.fixture(autouse=True)
def _verify_plans():
    """Every plan the port's balancer solves here goes through its static
    check (``repro_torch.analysis.plan_check``), as the reference's
    tests/conftest.py does for the JAX package's."""
    with plan_check.plan_verification():
        yield


def _case(rng, R=16, epr=4, alpha=1.2):
    """``tests/test_baselines.py``'s Pareto load."""
    E = R * epr
    lam = (rng.pareto(alpha, size=(R, E)) * 30).astype(np.int64)
    home = np.repeat(np.arange(R), epr)
    return lam, home, E, R


def _zipf(R, E, k, seed, tokens=4096):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, E + 1)
    p = p[rng.permutation(E)]
    return np.stack([rng.multinomial(tokens * k, p / p.sum())
                     for _ in range(R)]).astype(np.int64)


def _loads():
    """(name, lam, home, R): the Pareto cases and Zipf at E 128 / 256."""
    out = []
    for seed in range(3):
        lam, home, _, R = _case(np.random.default_rng(seed))
        out.append((f"pareto{seed}", lam, home, R))
    for E in (128, 256):
        out.append((f"zipf_e{E}", _zipf(64, E, 8, seed=E), np.repeat(
            np.arange(64), E // 64), 64))
    return out


LOADS = _loads()


@pytest.mark.parametrize("max_rep", [None, 1])
@pytest.mark.parametrize("name", [c[0] for c in LOADS])
def test_eplb_jax_matches_numpy(name, max_rep):
    """The placement (port, on the CPU: the kernel's plain version) equals
    JAX's ``eplb_replication_jit`` and numpy's float64 ``eplb_replication``;
    the round-robin split equals JAX's and numpy's."""
    _, lam, home, R = next(c for c in LOADS if c[0] == name)
    est = lam.sum(0).astype(np.float32)
    hosted_j = np.asarray(jeplb.eplb_replication_jit(
        jnp.asarray(est), jnp.asarray(home), R, n_slot=2,
        max_replicas_per_expert=max_rep))
    hosted_t = teplb.eplb_replication_dev(
        torch.from_numpy(est), torch.from_numpy(home), R, n_slot=2,
        max_replicas_per_expert=max_rep).numpy()
    np.testing.assert_array_equal(hosted_t, hosted_j)
    np.testing.assert_array_equal(
        hosted_t, teplb.eplb_replication(lam.sum(0), home, 2, max_rep))
    np.testing.assert_array_equal(
        teplb.eplb_replication(lam.sum(0), home, 2, max_rep),
        jeplb.eplb_replication(lam.sum(0), home, 2, max_rep))
    q_j = np.asarray(jeplb.round_robin_reroute_jax(jnp.asarray(lam),
                                                   jnp.asarray(hosted_j)))
    q_t = teplb.round_robin_reroute_dev(torch.from_numpy(lam),
                                        torch.from_numpy(hosted_t)).numpy()
    np.testing.assert_array_equal(q_t, q_j)
    np.testing.assert_array_equal(q_t, teplb.round_robin_reroute(lam,
                                                                 hosted_t))
    u, q, hosted = teplb.eplb_plan(lam, home, 2)
    ju, jq, jhosted = jeplb.eplb_plan(lam, home, 2)
    for a, b in ((u, ju), (q, jq), (hosted, jhosted)):
        np.testing.assert_array_equal(a, b)


def test_eplb_place_counts_its_steps():
    """stats = (steps, placements): every slot is placed or an expert
    retired at each step."""
    lam, home, E, R = _case(np.random.default_rng(1))
    stats = torch.zeros(2, dtype=torch.int32)
    hosted = eplb_ops.eplb_place(torch.from_numpy(lam.sum(0).astype(
        np.float32)), torch.from_numpy(home), R, n_slot=2, max_rep=R,
        stats=stats)
    steps, placed = stats.tolist()
    assert placed == int(hosted.sum()) - E
    assert placed <= R * 2 and steps <= R * 2 + E and steps >= placed


def test_round_robin_conserves():
    lam, home, E, R = _case(np.random.default_rng(0))
    hosted = teplb.eplb_replication_dev(
        torch.from_numpy(lam.sum(0)), torch.from_numpy(home), R, n_slot=2)
    q = teplb.round_robin_reroute_dev(torch.from_numpy(lam), hosted).numpy()
    assert np.array_equal(q.sum(axis=2), lam)
    # tokens only go to hosting instances
    assert (q.sum(axis=0)[~hosted.numpy()] == 0).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_lplb_one_replica_budget(seed):
    lam, home, E, R = _case(np.random.default_rng(seed))
    u, hosted, tau = tlplb.lplb_plan(lam, home, 2)
    ju, jhosted, jtau = jlplb.lplb_plan(lam, home, 2)
    np.testing.assert_array_equal(u, ju)
    np.testing.assert_array_equal(hosted, jhosted)
    assert tau == jtau
    reps = hosted.sum(axis=1) - 1
    assert (reps <= 1).all()
    assert np.array_equal(u.sum(axis=1), lam.sum(axis=0))


def test_ema_estimator():
    for mod in (teplb, jeplb):
        ema = mod.LoadEMA(4, decay=0.5)
        ema.update(np.array([4, 0, 0, 0.0]))
        ema.update(np.array([0, 4, 0, 0.0]))
        assert np.allclose(ema.value, [2, 2, 0, 0])


@pytest.mark.parametrize("rack_size", [None, 4])
@pytest.mark.parametrize("mode", MODES)
def test_balancer_modes_all_valid(mode, rack_size):
    """Every mode, flat and rack-aware: the whole plan equal to JAX's (tier
    volumes too), both marginals exact; ``eplb`` with a stale estimate."""
    lam, home, E, R = _case(np.random.default_rng(0), R=8)
    est = np.roll(lam.sum(0), E // 2).astype(np.float64)
    kw = dict(rack_size=rack_size)
    jp = jbal.solve(jnp.asarray(lam), jnp.asarray(home),
                    jbal.BalancerConfig(mode=mode, n_slot=2),
                    lam_e_est=jnp.asarray(est) if mode == "eplb" else None,
                    **kw)
    tp = tbal.solve(torch.from_numpy(lam), torch.from_numpy(home),
                    tbal.BalancerConfig(mode=mode, n_slot=2),
                    lam_e_est=torch.from_numpy(est) if mode == "eplb" else None,
                    **kw)
    fields = PLAN_FIELDS + (("tier_tokens", "tier_replicas")
                            if rack_size else ())
    for f in fields:
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    q = tp.q.numpy()
    assert np.array_equal(q.sum(axis=2), lam), mode
    assert np.array_equal(q.sum(axis=0), tp.u.numpy()), mode


@pytest.mark.parametrize("mode", ["eplb", "eplb_plus", "lplb", "ultraep"])
def test_balancer_on_zipf_loads_matches_jax(mode):
    """The baselines at GLM-4.5-Air's expert count (E 128, R 64, top-8)."""
    _, lam, home, R = next(c for c in LOADS if c[0] == "zipf_e128")
    jp = jbal.solve(jnp.asarray(lam, jnp.int32), jnp.asarray(home, jnp.int32),
                    jbal.BalancerConfig(mode=mode, n_slot=2))
    tp = tbal.solve(torch.from_numpy(lam), torch.from_numpy(home),
                    tbal.BalancerConfig(mode=mode, n_slot=2))
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)


def test_stale_eplb_worse_than_exact():
    """Fig. 6: placement from stale loads leaves residual imbalance when
    the distribution shifts; the port's plans equal JAX's."""
    lam_old, home, E, R = _case(np.random.default_rng(0), alpha=1.1)
    lam_new = np.roll(lam_old, E // 2, axis=1)
    old = lam_old.sum(0).astype(np.float64)
    stale = tbal.solve(torch.from_numpy(lam_new), torch.from_numpy(home),
                       tbal.BalancerConfig(mode="eplb", n_slot=2),
                       lam_e_est=torch.from_numpy(old))
    exact = tbal.solve(torch.from_numpy(lam_new), torch.from_numpy(home),
                       tbal.BalancerConfig(mode="eplb_plus", n_slot=2))
    u_stale, _, _ = jeplb.eplb_plan(lam_new, home, 2, lam_e_est=old)
    np.testing.assert_array_equal(stale.u.numpy(), u_stale)
    assert (tmetrics.imbalance(stale.u.sum(0))
            >= tmetrics.imbalance(exact.u.sum(0)) - 1e-9)


@pytest.mark.parametrize("mode", MODES)
def test_metrics_report_matches_jax(mode):
    lam, home, E, R = _case(np.random.default_rng(2), R=8)
    tp = tbal.solve(torch.from_numpy(lam), torch.from_numpy(home),
                    tbal.BalancerConfig(mode=mode, n_slot=2))
    rt = tmetrics.report(torch.from_numpy(lam), tp.u, torch.from_numpy(home))
    rj = jmetrics.report(lam, tp.u.numpy(), home)
    for f in ("total_instances", "max_fanout", "slots_used"):
        assert getattr(rt, f) == getattr(rj, f), f
    for f in ("pre_imbalance", "post_imbalance", "inflight_token_ratio"):
        assert abs(getattr(rt, f) - getattr(rj, f)) <= 1e-12, f
    assert tmetrics.imbalance(np.zeros(4)) == jmetrics.imbalance(np.zeros(4))


@pytest.mark.parametrize("P", [2, 4, 8])
def test_kary_probe_valid(P):
    """probe_parallelism > 1: the port's plan equals JAX's and obeys the
    validity invariants (tau may differ from the bisection's)."""
    rng = np.random.default_rng(0)
    for _ in range(3):
        R, epr = 8, 4
        E = R * epr
        lam = (rng.pareto(1.3, size=(R, E)) * 30.0).astype(np.int64)
        home = np.repeat(np.arange(R), epr)
        ju, jtau = jplan.solve_replication(jnp.asarray(lam), jnp.asarray(home),
                                           n_slot=2, u_min=4,
                                           probe_parallelism=P)
        u, tau = tplan.solve_replication(torch.from_numpy(lam),
                                         torch.from_numpy(home), n_slot=2,
                                         u_min=4, probe_parallelism=P)
        np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
        assert int(tau) == int(jtau)
        u = u.numpy()
        assert np.array_equal(u.sum(axis=1), lam.sum(axis=0))
        assert u.sum(axis=0).max() <= int(tau)
        is_rep = (u.T > 0) & (home[None, :] != np.arange(R)[:, None])
        assert (is_rep.sum(axis=1) <= 2).all()


def test_balancer_rejects_unknown_modes():
    with pytest.raises(ValueError):
        tbal.BalancerConfig(mode="greedy")
    with pytest.raises(ValueError):
        tbal.BalancerConfig(probe_parallelism=0)
