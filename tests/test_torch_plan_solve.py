"""The plan solve: the port's plain version vs the JAX planner and the numpy
oracle, the R = 1 short-circuit, and the CUDA kernel vs the plain version.

CPU: the same numpy load matrices (4096 tokens a rank, top-k, over three
expert popularity laws: uniform, Zipf s = 1.0, and four hot experts taking
half the load) go through ``repro.core.planner.solve_plan`` (JAX),
``repro.core.ref_planner.solve`` (numpy) and the port's ``solve_plan`` at
R 1 to 64; every integer table must be equal.  At R = 1 the port returns
the home quota with ``tau = total`` and never reaches the solve's loops.

Card: the kernel equals the plain version bitwise (u, tau, and the count
of probes and oracle steps) in the same cases and in the whole ``Plan``;
it is captured and replayed in a CUDA graph; neither the solve at R > 1
nor the MoE layer at R = 1 syncs with the host; the wrapper raises where
the shapes allow a total load of 2^31 or more, and on E % R != 0.

The JAX side is imported inside the tests that use it, so the card tests
also run where JAX is not installed:
  PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
      tests/test_torch_plan_solve.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import planner
from repro_torch.kernels.plan_solve import ops

LAWS = ("uniform", "zipf", "hot4")
PLAN_FIELDS = ("u", "q", "x", "tau", "hosted", "cum_q", "cum_u", "pre_max",
               "post_max")
# (R, E, k): GLM-4.5-Air / Qwen3-235B-A22B (E 128, top-8) and Jamba-v0.1
# (E 16, top-2).
CASES = ([(R, 128, 8) for R in (1, 2, 4, 8, 16, 32, 64)]
         + [(R, 16, 2) for R in (2, 4, 8, 16)])


def _lam(R, E, k, law, seed, tokens=4096):
    """(R, E) int64 load: each rank's tokens x k items drawn from one
    expert popularity law."""
    rng = np.random.default_rng(seed)
    if law == "uniform":
        p = np.ones(E)
    elif law == "zipf":
        p = 1.0 / np.arange(1, E + 1)
        p = p[rng.permutation(E)]
    else:
        p = np.full(E, 0.5 / (E - 4))
        p[rng.choice(E, 4, replace=False)] = 0.5 / 4
    return np.stack([rng.multinomial(tokens * k, p / p.sum())
                     for _ in range(R)]).astype(np.int64)


def _home(R, E):
    return np.repeat(np.arange(R), E // R).astype(np.int64)


def _solve_inputs(lam, home):
    R = lam.shape[0]
    lam_e = lam.sum(dim=0)
    return (lam_e, planner._rank_load(lam_e, home, R),
            planner._expert_order(lam_e, home, R))


@pytest.mark.parametrize("law", LAWS)
@pytest.mark.parametrize("R,E,k", CASES)
def test_plain_solve_matches_jax_and_oracle(R, E, k, law):
    import jax.numpy as jnp

    from repro.core import planner as jplan
    from repro.core import ref_planner

    lam = _lam(R, E, k, law, seed=R + LAWS.index(law))
    home = _home(R, E)
    tp = planner.solve_plan(torch.from_numpy(lam), torch.from_numpy(home),
                            n_slot=2)
    jp = jplan.solve_plan(jnp.asarray(lam, jnp.int32),
                          jnp.asarray(home, jnp.int32), n_slot=2)
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jp, f)),
                                      getattr(tp, f).numpy(), err_msg=f)
    ref = ref_planner.solve(lam, home, n_slot=2)
    np.testing.assert_array_equal(ref.u, tp.u.numpy())
    np.testing.assert_array_equal(ref.x, tp.x.numpy())
    assert ref.tau == int(tp.tau)


@pytest.mark.parametrize("law", LAWS)
def test_single_rank_short_circuit_matches_jax(law, monkeypatch):
    """R = 1: the home quota and tau = total, with no solve at all."""
    import jax.numpy as jnp

    from repro.core import planner as jplan

    def no_solve(*args, **kwargs):
        raise AssertionError("R = 1 must not reach the solve")

    monkeypatch.setattr(planner, "plan_solve", no_solve)
    lam = _lam(1, 128, 8, law, seed=11)
    home = _home(1, 128)
    u, tau = planner.solve_replication(torch.from_numpy(lam),
                                       torch.from_numpy(home), n_slot=2)
    ju, jtau = jplan.solve_replication(jnp.asarray(lam, jnp.int32),
                                       jnp.asarray(home, jnp.int32), n_slot=2)
    np.testing.assert_array_equal(np.asarray(ju), u.numpy())
    assert int(jtau) == int(tau) == lam.sum()
    assert tau.dim() == 0 and tau.dtype == torch.int64


def test_plain_solve_counts_its_steps():
    """stats = (probes, oracle steps): probes are the bisection's
    ceil(log2(hi - lo + 1)) or fewer, steps at least one a rank a probe."""
    R, E = 8, 128
    lam = torch.from_numpy(_lam(R, E, 8, "zipf", seed=3))
    lam_e, ell, rexp = _solve_inputs(lam, torch.from_numpy(_home(R, E)))
    stats = torch.zeros(2, dtype=torch.int32)
    ops.plan_solve(lam_e, ell, torch.from_numpy(_home(R, E)), rexp, n_slot=2,
                   u_min=1, max_replicas_per_expert=R, load_bound=None,
                   stats=stats)
    lo, hi = -(-int(ell.sum()) // R), int(ell.max())
    probes, steps = stats.tolist()
    assert 1 <= probes <= int(np.ceil(np.log2(hi - lo + 1)))
    assert steps >= probes * R


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel builds with nvcc for "
                    "sm_90a")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("law", LAWS)
@pytest.mark.parametrize("R,E,k", [c for c in CASES if c[0] > 1])
def test_kernel_matches_plain_on_card(cuda_device, R, E, k, law):
    lam = torch.from_numpy(_lam(R, E, k, law, seed=R + LAWS.index(law)))
    home = torch.from_numpy(_home(R, E))
    lam_e, ell, rexp = _solve_inputs(lam, home)
    ref_stats = torch.zeros(2, dtype=torch.int32)
    u_ref, tau_ref = ops.plan_solve_ref(lam_e, ell, home, rexp, n_slot=2,
                                        u_min=1, max_replicas_per_expert=R,
                                        stats=ref_stats)
    stats = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    before = ops.plan_solve.launches
    u, tau = ops.plan_solve(*(t.to(cuda_device) for t in (lam_e, ell, home,
                                                          rexp)),
                            n_slot=2, u_min=1, max_replicas_per_expert=R,
                            load_bound=R * 4096 * k, stats=stats)
    torch.cuda.synchronize()
    assert ops.plan_solve.launches == before + 1
    assert u.dtype == tau.dtype == torch.int64
    assert torch.equal(u.cpu(), u_ref) and int(tau) == int(tau_ref)
    assert torch.equal(stats.cpu(), ref_stats)
    plan = planner.solve_plan(lam.to(cuda_device), home.to(cuda_device),
                              n_slot=2, load_bound=R * 4096 * k)
    plain = planner.solve_plan(lam, home, n_slot=2)
    for f in PLAN_FIELDS:
        assert torch.equal(getattr(plan, f).cpu(), getattr(plain, f)), f


@pytest.mark.cuda
def test_kernel_under_cuda_graph(cuda_device):
    R, E, k = 64, 128, 8
    lam = torch.from_numpy(_lam(R, E, k, "zipf", seed=5)).to(cuda_device)
    home = torch.from_numpy(_home(R, E)).to(cuda_device)
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        eager = planner.solve_plan(lam, home, n_slot=2, load_bound=R * 4096 * k)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=s):
        captured = planner.solve_plan(lam, home, n_slot=2,
                                      load_bound=R * 4096 * k)
    other = torch.from_numpy(_lam(R, E, k, "hot4", seed=6)).to(cuda_device)
    want = planner.solve_plan(other, home, n_slot=2, load_bound=R * 4096 * k)
    g.replay()
    torch.cuda.synchronize()
    for f in PLAN_FIELDS:
        assert torch.equal(getattr(captured, f), getattr(eager, f)), f
    lam.copy_(other)          # a replay solves whatever the input holds
    g.replay()
    torch.cuda.synchronize()
    for f in PLAN_FIELDS:
        assert torch.equal(getattr(captured, f), getattr(want, f)), f


@pytest.mark.cuda
def test_solve_and_single_rank_layer_do_not_sync(cuda_device):
    from repro_torch.core.balancer import BalancerConfig
    from repro_torch.moe.gating import GatingConfig
    from repro_torch.moe.layer import MoEConfig, init_moe_params, moe_layer_local

    R, E, k = 32, 128, 8
    lam = torch.from_numpy(_lam(R, E, k, "hot4", seed=7)).to(cuda_device)
    home = torch.from_numpy(_home(R, E)).to(cuda_device)
    planner.solve_plan(lam, home, n_slot=2, load_bound=R * 4096 * k)
    torch.cuda.synchronize()
    for mode in ("a2a", "replicated"):
        cfg = MoEConfig(gating=GatingConfig(num_experts=E, top_k=k,
                                            aux_loss_weight=1e-2),
                        balancer=BalancerConfig(mode="ultraep", n_slot=2),
                        d_model=128, d_ff=64, ep_size=1, cap_pair=4096,
                        cap_slot=512, dispatch_mode=mode)
        gen = torch.Generator(device=cuda_device).manual_seed(0)
        params = init_moe_params(cfg, gen, device=cuda_device)
        x = torch.randn((512, 128), generator=gen, device=cuda_device)
        moe_layer_local(x, params, cfg)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            planner.solve_plan(lam, home, n_slot=2, load_bound=R * 4096 * k)
            moe_layer_local(x, params, cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
def test_wrapper_raises_on_unsafe_shapes(cuda_device):
    R, E = 4, 16
    lam = torch.from_numpy(_lam(R, E, 2, "uniform", seed=1))
    home = torch.from_numpy(_home(R, E))
    args = [t.to(cuda_device) for t in _solve_inputs(lam, home)]
    lam_e, ell, rexp = args
    kw = dict(n_slot=2, u_min=1, max_replicas_per_expert=R)
    with pytest.raises(ValueError, match="2\\^31"):
        ops.plan_solve(lam_e, ell, home.to(cuda_device), rexp,
                       load_bound=2 ** 31, **kw)
    with pytest.raises(ValueError, match="2\\^31"):
        ops.plan_solve(lam_e, ell, home.to(cuda_device), rexp,
                       load_bound=None, **kw)
    with pytest.raises(ValueError, match="multiple"):
        ops.plan_solve(lam_e[:15].contiguous(), ell, home[:15].to(cuda_device),
                       rexp, load_bound=1000, **kw)
    with pytest.raises(ValueError, match="2\\^31"):
        # The layer's bound: 4 ranks x 2^28 tokens x top-2 = 2^31.
        planner.solve_plan(lam.to(cuda_device), home.to(cuda_device),
                           n_slot=2, load_bound=R * 2 ** 28 * 2)


def test_wrapper_rejects_other_devices():
    t = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        ops.plan_solve(t, t[:2], t, t.reshape(2, 2), n_slot=2, u_min=1,
                       max_replicas_per_expert=2, load_bound=8)


# Rack mode (row Pr): PLAN_CASES at rack size 8, and R 4 at rack size 2.
RACK_CASES = [(R, 128, 8, 8) for R in (8, 16, 32, 64)] + [(4, 16, 2, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("demand", [False, True], ids=["plain", "demand"])
@pytest.mark.parametrize("law", LAWS)
@pytest.mark.parametrize("R,E,k,L", RACK_CASES)
def test_kernel_rack_mode_matches_plain_on_card(cuda_device, R, E, k, L, law,
                                                demand):
    """The rack score and, with ``demand``, the (G, E) incidence computed
    on the card: u, tau and (probes, steps) equal the plain version's, the
    whole Plan (tier fields too) the plain solve's, with no host sync."""
    lam = _lam(R, E, k, law, seed=R + L + LAWS.index(law))
    # Each rack keeps its tokens off a third of the experts, so the
    # incidence differs between racks.
    rng = np.random.default_rng(R)
    for g in range(R // L):
        lam[g * L:(g + 1) * L, rng.choice(E, E // 3, replace=False)] = 0
    lam = torch.from_numpy(lam)
    home = torch.from_numpy(_home(R, E))
    lam_e, ell, rexp = _solve_inputs(lam, home)
    ref_stats = torch.zeros(2, dtype=torch.int32)
    u_ref, tau_ref = ops.plan_solve_ref(
        lam_e, ell, home, rexp, n_slot=2, u_min=1, max_replicas_per_expert=R,
        stats=ref_stats, rack_size=L, lam=lam if demand else None)
    stats = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    d = [t.to(cuda_device) for t in (lam_e, ell, home, rexp, lam)]
    u, tau = ops.plan_solve(*d[:4], n_slot=2, u_min=1,
                            max_replicas_per_expert=R,
                            load_bound=R * 4096 * k, stats=stats,
                            rack_size=L, lam=d[4] if demand else None)
    torch.cuda.synchronize()
    assert torch.equal(u.cpu(), u_ref) and int(tau) == int(tau_ref)
    assert torch.equal(stats.cpu(), ref_stats)
    kw = dict(n_slot=2, rack_size=L, demand_tiebreak=demand)
    plain = planner.solve_plan(lam, home, **kw)
    torch.cuda.set_sync_debug_mode("error")
    try:
        plan = planner.solve_plan(d[4], d[2], load_bound=R * 4096 * k, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for f in PLAN_FIELDS + ("tier_tokens", "tier_replicas"):
        assert torch.equal(getattr(plan, f).cpu(), getattr(plain, f)), f


@pytest.mark.cuda
def test_kernel_one_rack_is_the_flat_solve(cuda_device):
    R, E, k = 16, 128, 8
    lam = torch.from_numpy(_lam(R, E, k, "zipf", seed=2)).to(cuda_device)
    home = torch.from_numpy(_home(R, E)).to(cuda_device)
    flat = planner.solve_plan(lam, home, n_slot=2, load_bound=R * 4096 * k)
    one = planner.solve_plan(lam, home, n_slot=2, rack_size=R,
                             demand_tiebreak=True, load_bound=R * 4096 * k)
    for f in PLAN_FIELDS:
        assert torch.equal(getattr(one, f), getattr(flat, f)), f


@pytest.mark.cuda
def test_wrapper_raises_at_the_rack_mode_bound(cuda_device):
    R, E, L = 4, 16, 2
    lam = torch.from_numpy(_lam(R, E, 2, "uniform", seed=1)).to(cuda_device)
    home = torch.from_numpy(_home(R, E)).to(cuda_device)
    for demand, bound in ((False, 2 ** 30), (True, 2 ** 29)):
        with pytest.raises(ValueError, match="slack scale"):
            planner.solve_plan(lam, home, n_slot=2, rack_size=L,
                               demand_tiebreak=demand, load_bound=bound)
        planner.solve_plan(lam, home, n_slot=2, rack_size=L,
                           demand_tiebreak=demand, load_bound=bound - 1)


# Rows Pk and Ph: the k-ary round and the health mode in the kernel, flat
# and rack-aware, against the plain version (u, tau and (probes, steps,
# critical path) equal) and the whole Plan against the plain solve.
KARY_CASES = [(64, 128, 8, None), (64, 128, 8, 8), (64, 256, 8, None),
              (16, 16, 2, None), (8, 128, 8, 2)]


def _weights(R, kind):
    w = np.ones(R)
    if kind == "half_and_zero":
        w[1], w[2] = 0.5, 0.0
    elif kind == "arbitrary":
        w = np.random.default_rng(R).uniform(0.1, 1.0, R)
    elif kind == "all_zero":
        w[:] = 0.0
    return torch.from_numpy(w)


def _card_vs_plain(cuda_device, R, E, k, L, law, **opts):
    lam = torch.from_numpy(_lam(R, E, k, law, seed=R + E))
    home = torch.from_numpy(_home(R, E))
    lam_e, ell, rexp = _solve_inputs(lam, home)
    hw = opts.get("health_weight")
    ref_stats = torch.zeros(3, dtype=torch.int32)
    u_ref, tau_ref = ops.plan_solve_ref(
        lam_e, ell, home, rexp, n_slot=2, u_min=1, max_replicas_per_expert=R,
        stats=ref_stats, rack_size=L, **opts)
    stats = torch.zeros(3, dtype=torch.int32, device=cuda_device)
    d = [t.to(cuda_device) for t in (lam_e, ell, home, rexp)]
    dopts = dict(opts)
    if hw is not None:
        dopts["health_weight"] = hw.to(cuda_device)
    before = ops.plan_solve.launches
    u, tau = ops.plan_solve(*d, n_slot=2, u_min=1, max_replicas_per_expert=R,
                            load_bound=R * 4096 * k, stats=stats,
                            rack_size=L, **dopts)
    torch.cuda.synchronize()
    assert ops.plan_solve.launches == before + 1
    assert torch.equal(u.cpu(), u_ref) and int(tau) == int(tau_ref)
    assert torch.equal(stats.cpu(), ref_stats)
    kw = dict(n_slot=2, rack_size=L, **opts)
    plain = planner.solve_plan(lam, home, **kw)
    kw.update(dopts)
    lam_d, home_d = lam.to(cuda_device), home.to(cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        plan = planner.solve_plan(lam_d, home_d, load_bound=R * 4096 * k,
                                  **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for f in PLAN_FIELDS:
        assert torch.equal(getattr(plan, f).cpu(), getattr(plain, f)), f
    return plain


@pytest.mark.cuda
@pytest.mark.parametrize("P", [2, 4, 8, 12])
@pytest.mark.parametrize("R,E,k,L", KARY_CASES)
def test_kernel_kary_matches_plain_on_card(cuda_device, R, E, k, L, P):
    _card_vs_plain(cuda_device, R, E, k, L, "zipf", probe_parallelism=P)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 4])
@pytest.mark.parametrize("kind", ["half_and_zero", "arbitrary", "all_zero"])
@pytest.mark.parametrize("R,E,k,L", [(64, 128, 8, None), (64, 128, 8, 8),
                                     (16, 16, 2, None)])
def test_kernel_health_matches_plain_on_card(cuda_device, R, E, k, L, kind,
                                             P):
    plain = _card_vs_plain(cuda_device, R, E, k, L, "hot4",
                           health_weight=_weights(R, kind),
                           probe_parallelism=P)
    if kind == "half_and_zero":
        assert int(plain.u.sum(dim=0)[2]) == 0


@pytest.mark.cuda
def test_wrapper_raises_at_the_kary_and_health_bounds(cuda_device):
    R, E = 4, 16
    lam = torch.from_numpy(_lam(R, E, 2, "uniform", seed=1)).to(cuda_device)
    home = torch.from_numpy(_home(R, E)).to(cuda_device)
    with pytest.raises(ValueError, match="2\\^31"):
        planner.solve_plan(lam, home, n_slot=2, probe_parallelism=8,
                           load_bound=2 ** 28)
    planner.solve_plan(lam, home, n_slot=2, probe_parallelism=8,
                       load_bound=2 ** 28 - 1)
    w = torch.ones(R, device=cuda_device)
    with pytest.raises(ValueError, match="2\\^31"):
        planner.solve_plan(lam, home, n_slot=2, health_weight=w,
                           load_bound=2 ** 30)


# Row Pe: EPLB's placement on the card against its plain version, bitwise,
# at E 128 and E 256, R 64, over Zipf loads, with no host sync; R 128 and
# R 256 (8 ranks a lane), and E 1024 and R 256, the kernel's largest (lists
# in shared memory).
@pytest.mark.cuda
@pytest.mark.parametrize("max_rep", [None, 1])
@pytest.mark.parametrize("R,E", [(64, 128), (64, 256), (16, 64), (4, 16),
                                 (128, 512), (2, 512), (256, 256),
                                 (256, 1024), (32, 1024)])
def test_eplb_place_matches_plain_on_card(cuda_device, R, E, max_rep):
    from repro_torch.core import eplb
    from repro_torch.kernels.eplb_place import ops as eplb_ops

    lam_e = torch.from_numpy(_lam(R, E, 8, "zipf", seed=E).sum(0)).float()
    home = torch.from_numpy(_home(R, E))
    mr = R if max_rep is None else max_rep + 1
    ref_stats = torch.zeros(2, dtype=torch.int32)
    want = eplb_ops.eplb_place_ref(lam_e, home, R, n_slot=2, max_rep=mr,
                                   stats=ref_stats)
    stats = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    d_lam, d_home = lam_e.to(cuda_device), home.to(cuda_device)
    before = eplb_ops.eplb_place.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = eplb_ops.eplb_place(d_lam, d_home, R, n_slot=2, max_rep=mr,
                                  stats=stats)
        hosted = eplb.eplb_replication_dev(d_lam, d_home, R, n_slot=2,
                                           max_replicas_per_expert=max_rep)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert eplb_ops.eplb_place.launches == before + 2
    assert torch.equal(got.cpu(), want) and torch.equal(hosted.cpu(), want)
    assert torch.equal(stats.cpu(), ref_stats)
