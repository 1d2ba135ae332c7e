"""The port's relay-schedule checker (``repro_torch.analysis.sched_check``)
against the JAX package's, on the CPU: the schedule cases of
``tests/test_analysis.py``.

* Real relay trees: the port's ``build_relay_schedule`` over the port's
  plans (``ultraep`` and ``eplb_plus`` at R 8, racks of 4) gives no error,
  and the same violations from both checkers.
* Hand-built faults: a dependency cycle, dangling dependencies, a relay
  race, a double write, a self-send with a wrong volume, an undelivered
  replica and an over-subscribed channel each give the same violations
  (rule, severity, message) in both checkers, the expected rule among
  them; ``assert_schedule_valid`` raises on the errors.
"""

import numpy as np
import pytest
import torch

from repro.analysis import sched_check as jsc
from repro.core.topology import Topology as JTopology
from repro_torch.analysis import plan_check, sched_check
from repro_torch.analysis.violation import errors
from repro_torch.core import balancer
from repro_torch.core.comm_plan import Edge, RelaySchedule, build_relay_schedule
from repro_torch.core.topology import Topology

HOME4 = np.zeros(4, dtype=np.int64)          # every expert homed at rank 0


def _sched(edges, R):
    vol = np.zeros(R, dtype=np.int64)
    for e in edges:
        vol[e.src] += e.nbytes
    return RelaySchedule(edges=list(edges), send_volume=vol)


def _both(sched, **kw):
    """The port's violations, asserted equal to JAX's on the same schedule
    (its topology, if any, given to each checker as its own class)."""
    jkw = dict(kw)
    if kw.get("topology") is not None:
        t = kw["topology"]
        jkw["topology"] = JTopology(racks=t.racks,
                                    ranks_per_rack=t.ranks_per_rack)
    tv = sched_check.verify_schedule(sched, **kw)
    jv = jsc.verify_schedule(sched, **jkw)
    assert [str(v) for v in tv] == [str(v) for v in jv]
    return tv


@pytest.mark.parametrize("mode", ["ultraep", "eplb_plus"])
def test_real_relay_trees_are_green_in_both(mode):
    rng = np.random.default_rng(5)
    w = 1.0 / np.arange(1, 33) ** 1.2
    lam = rng.poisson(256 * w[None, :] / w.sum(), size=(8, 32))
    home = np.repeat(np.arange(8, dtype=np.int64), 4)
    with plan_check.plan_verification():
        plan = balancer.solve(torch.from_numpy(lam), torch.from_numpy(home),
                              balancer.BalancerConfig(mode=mode, n_slot=2),
                              rack_size=4)
    topo = Topology(racks=2, ranks_per_rack=4)
    hosted = plan_check.hosted_matrix(plan)
    for sched in (build_relay_schedule(hosted, home, 1 << 20, num_ranks=8,
                                       topology=topo),
                  build_relay_schedule(hosted, home, 1 << 20, num_ranks=8)):
        vio = _both(sched, home=home, hosted=hosted, topology=topo)
        assert not errors(vio), "\n".join(map(str, vio))
        sched_check.assert_schedule_valid(sched, home=home, hosted=hosted)


def _undelivered():
    hosted = np.zeros((4, 4), dtype=bool)
    hosted[0, 0] = hosted[0, 2] = True       # a main and a planned replica
    return hosted


def _bad_volume():
    s = _sched([Edge(0, 0, 0, 64, 0)], 4)
    s.send_volume[0] += 1
    return s


# name -> (schedule, checker arguments, the rules that must fire, errors)
FAULTS = {
    "cycle": (lambda: _sched([Edge(1, 2, 0, 64, 1, depends_on=1),
                              Edge(2, 1, 0, 64, 1, depends_on=0)], 4),
              {}, {"deadlock-cycle"}),
    "dangling": (lambda: _sched([Edge(0, 1, 0, 64, 0),
                                 Edge(1, 2, 0, 64, 1, depends_on=-1),
                                 Edge(1, 3, 0, 64, 1, depends_on=99)], 4),
                 {}, {"dangling-dep"}),
    "relay_race": (lambda: _sched([Edge(0, 1, 0, 64, 0),
                                   Edge(1, 2, 1, 64, 1, depends_on=0)], 4),
                   {}, {"relay-race"}),
    "double_write": (lambda: _sched([Edge(0, 2, 0, 64, 0),
                                     Edge(0, 2, 0, 64, 0)], 4),
                     {}, {"double-write"}),
    "self_send_volume": (_bad_volume, {}, {"self-send",
                                           "volume-accounting"}),
    "undelivered": (lambda: _sched([Edge(0, 1, 0, 64, 0)], 4),
                    {"hosted": _undelivered()}, {"unreachable-dest"}),
}


@pytest.mark.parametrize("name", list(FAULTS))
def test_faults_give_the_same_violations(name):
    make, kw, rules = FAULTS[name]
    sched = make()
    vio = _both(sched, home=HOME4, **kw)
    assert rules <= {v.rule for v in errors(vio)}
    if name == "dangling":
        assert sum(v.rule == "dangling-dep" for v in errors(vio)) == 2
    with pytest.raises(sched_check.ScheduleViolationError):
        sched_check.assert_schedule_valid(sched, home=HOME4, **kw)


def test_oversubscribed_channel_warns_in_both():
    edges = [Edge(0, d, 0, 1 << 22, 0) for d in range(1, 8)]
    edges += [Edge(s, (s + 1) % 8, s, 1 << 12, 0) for s in range(1, 8)]
    home = np.zeros(8, np.int64)
    vio = _both(_sched(edges, 8), home=home)
    assert any(v.rule == "channel-oversubscription" and v.severity == "warn"
               for v in vio)
    vio = _both(_sched(edges, 8), home=home,
                topology=Topology(racks=2, ranks_per_rack=4))
    assert any(v.rule == "channel-oversubscription" for v in vio)
    assert not _both(_sched([], 8), home=np.zeros(1, np.int64))
