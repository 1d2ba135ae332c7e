"""``repro_torch.examples`` on the CPU against the reference's examples.

The quickstart: the plan of the reference's load matrix (the same numpy
draw) equals the JAX planner's, field for field of the quota table, and
its Table-4 metrics (pre- and post-balance imbalance, replicas, fan-out)
equal the reference's report; the balanced layer, on the port's weights
and tokens, equals JAX ``moe_layer_local`` on the same ones within 1e-4
of max|y| (fp32 on both sides, sums in other orders), and both equal the
dense per-token oracle within that tolerance.
"""

import numpy as np
import pytest
import torch

from repro_torch.examples import quickstart


@pytest.fixture(scope="module")
def port_run():
    return quickstart.main(["--device", "cpu"])


def test_quickstart_plan_matches_jax(port_run):
    import jax.numpy as jnp

    from repro.core import metrics
    from repro.core.planner import solve_plan

    lam = quickstart.load_matrix()
    home = np.repeat(np.arange(quickstart.R), quickstart.E // quickstart.R)
    plan = solve_plan(jnp.asarray(lam), jnp.asarray(home), n_slot=2, u_min=8)
    want = metrics.report(lam, np.array(plan.u), home)
    np.testing.assert_array_equal(port_run["u"], np.array(plan.u))
    got = port_run["report"]
    for field in ("pre_imbalance", "post_imbalance", "slots_used",
                  "max_fanout", "total_instances", "inflight_token_ratio"):
        assert getattr(got, field) == getattr(want, field), field


def test_quickstart_layer_matches_jax(port_run):
    import jax.numpy as jnp

    from repro.core.balancer import BalancerConfig
    from repro.moe.gating import GatingConfig
    import jax

    from repro.moe.layer import MoEConfig, MoEParams, moe_layer_local

    assert port_run["finite"] and port_run["drops"] == 0
    assert port_run["layer_max_err"] <= 1e-4 * port_run["layer_max_ref"]
    y, y_ref, _ = quickstart.balanced_layer("cpu")
    # The same weights and tokens through the reference's layer.
    T, D, F, K, E = (quickstart.T, quickstart.D, quickstart.F, quickstart.K,
                     quickstart.E)
    from repro_torch.core.balancer import BalancerConfig as PortBalancer
    from repro_torch.moe.gating import GatingConfig as PortGating
    from repro_torch.moe.layer import MoEConfig as PortConfig
    from repro_torch.moe.layer import init_moe_params

    gen = torch.Generator().manual_seed(0)
    p = init_moe_params(PortConfig(
        gating=PortGating(num_experts=E, top_k=K),
        balancer=PortBalancer(mode="ultraep", n_slot=2), d_model=D, d_ff=F,
        ep_size=1, cap_pair=T * K, cap_slot=T * K), gen, device="cpu")
    x = torch.randn((T, D), generator=gen)
    gcfg = GatingConfig(num_experts=E, top_k=K)
    cfg = MoEConfig(gating=gcfg,
                    balancer=BalancerConfig(mode="ultraep", n_slot=2),
                    d_model=D, d_ff=F, ep_size=1, cap_pair=T * K,
                    cap_slot=T * K)
    params = MoEParams(*(jnp.asarray(t.detach().numpy())
                         for t in (p.router, p.w1, p.w3, p.w2)))
    yj = np.asarray(jax.jit(lambda x: moe_layer_local(
        x, params, cfg, axis_name=None)[0])(jnp.asarray(x.numpy())))
    scale = np.abs(yj).max()
    assert np.abs(y.numpy() - yj).max() <= 1e-4 * scale
    assert np.abs(y_ref.numpy() - yj).max() <= 1e-4 * scale
