"""Quickstart: solve a balancing plan, inspect it, and run one balanced
MoE layer -- the paper's core loop, the port's counterpart of
``examples/quickstart.py``.

On the card (the plan through the plan-solve kernel, the layer through the
gating and grouped-GEMM kernels) or, with ``--device cpu``, their plain
versions:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The load matrix is the reference's (``np.random.default_rng(0)``), so the
plan and its metrics are the reference's; the layer's weights and tokens
come from a ``torch.Generator`` (JAX's keys give other numbers), and the
layer is held against the dense per-token oracle ``moe_ref``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import metrics
from repro_torch.core.balancer import BalancerConfig
from repro_torch.core.planner import solve_plan
from repro_torch.moe.gating import GatingConfig, gate
from repro_torch.moe.layer import MoEConfig, init_moe_params, moe_layer_local
from repro_torch.moe.reference import moe_ref

__all__ = ["load_matrix", "plan_and_report", "balanced_layer", "main"]

R, E = 16, 64                       # EP ranks, logical experts
T, D, F, K = 256, 64, 128, 4        # tokens, model width, expert width, top-k


def load_matrix() -> np.ndarray:
    """The skewed (R, E) load matrix: Pareto(1.2) x 30, int32."""
    rng = np.random.default_rng(0)
    return (rng.pareto(1.2, size=(R, E)) * 30).astype(np.int32)


def plan_and_report(device="cuda"):
    """The exact-load plan of :func:`load_matrix` (2 slots a rank, at
    least 8 tokens a replica) and its Table-4 metrics."""
    lam_np = load_matrix()
    lam = torch.from_numpy(lam_np).to(device)
    home = torch.repeat_interleave(torch.arange(R, device=device), E // R)
    plan = solve_plan(lam, home, n_slot=2, u_min=8,
                      load_bound=int(lam_np.sum()))
    return plan, metrics.report(lam_np, plan.u, home)


def balanced_layer(device="cuda", seed: int = 0):
    """One balanced MoE layer at one EP rank (T tokens, E experts, top-K)
    and the dense oracle on the same routing: ``(y, y_ref, stats)``."""
    gcfg = GatingConfig(num_experts=E, top_k=K)
    cfg = MoEConfig(gating=gcfg,
                    balancer=BalancerConfig(mode="ultraep", n_slot=2),
                    d_model=D, d_ff=F, ep_size=1,
                    cap_pair=T * K, cap_slot=T * K)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_moe_params(cfg, gen, device=device)
    x = torch.randn((T, D), generator=gen, device=device)
    with torch.no_grad():
        y, _, stats = moe_layer_local(x, params, cfg)
        go = gate(x, params.router, gcfg)
        y_ref = moe_ref(x, go.expert_ids, go.weights, params.w1, params.w3,
                        params.w2)
    return y, y_ref, stats


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    # --- 1. Exact-load planning on a skewed load matrix ----------------
    plan, rep = plan_and_report(device)
    print(f"pre-balance imbalance : {rep.pre_imbalance:.2f}x")
    print(f"post-balance imbalance: {rep.post_imbalance:.2f}x "
          f"(paper: 1.01-1.04)")
    print(f"replicas materialised : {rep.slots_used} "
          f"(budget {R * 2}), max fan-out {rep.max_fanout}")

    # --- 2. A balanced MoE layer end-to-end ----------------------------
    y, y_ref, stats = balanced_layer(device)
    err = float((y - y_ref).abs().max())
    print(f"\nbalanced MoE layer == per-token oracle: max |err| = {err:.2e}")
    print(f"pre_max rank load {int(stats.pre_max)} -> post_max "
          f"{int(stats.post_max)}; drops {int(stats.drops_dispatch)}")
    return {"report": rep, "u": plan.u.cpu().numpy(), "layer_max_err": err,
            "layer_max_ref": float(y_ref.abs().max()),
            "drops": int(stats.drops_dispatch + stats.drops_slot),
            "finite": bool(torch.isfinite(y).all())}


if __name__ == "__main__":
    main()
