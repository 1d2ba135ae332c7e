"""Balancing demo: watch UltraEP react to a non-stationary load trace, the
port's counterpart of ``examples/balancing_demo.py``.

Streams the synthetic domain-mixture data through a router and balances
every step with each algorithm, printing the per-step post-balance
imbalance -- the Fig. 6 story (EPLB's stale placements lag the shifting
hot experts; UltraEP tracks them exactly).  On the card the router runs
the gating kernel and ``ultraep`` the plan-solve kernel; ``--device cpu``
runs their plain versions.  The embedding and router weights come from a
``torch.Generator`` (the reference draws them from JAX keys, so the
numbers differ; the stream is the same):

    PYTHONPATH=src python -m repro_torch.examples.balancing_demo [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import balancer as bal
from repro_torch.core import metrics
from repro_torch.core.balancer import BalancerConfig
from repro_torch.core.eplb import LoadEMA
from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
from repro_torch.moe.gating import GatingConfig, gate

__all__ = ["main"]

R, E, D, K = 16, 64, 32, 4
MODES = ("eplb", "eplb_plus", "ultraep")


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=24)
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    stream = SyntheticLMStream(DataConfig(vocab_size=256, seq_len=128,
                                          global_batch=8, switch_period=6))
    gen = torch.Generator(device=device).manual_seed(0)
    emb = torch.randn((256, D), generator=gen, device=device)
    wr = torch.randn((D, E), generator=gen, device=device) * D ** -0.5
    gcfg = GatingConfig(num_experts=E, top_k=K)
    home_np = np.repeat(np.arange(R), E // R)
    home = torch.from_numpy(home_np).to(device)
    ema = LoadEMA(E, decay=0.8)
    stale = None
    rows = []
    print(f"{'step':>4s} {'pre':>6s} {'eplb':>6s} {'eplb+':>6s} "
          f"{'ultraep':>8s}")
    for s in range(args.steps):
        toks = torch.from_numpy(
            stream.batch(s)["tokens"].reshape(-1).astype(np.int64)).to(device)
        go = gate(emb[toks], wr, gcfg)
        # Split the token load across EP source ranks (round-robin shards).
        ids = go.expert_ids.reshape(-1).cpu().numpy()
        lam = np.zeros((R, E), np.int64)
        np.add.at(lam, (np.arange(ids.size) % R, ids), 1)
        lam_t = torch.from_numpy(lam).to(device)
        if s % 5 == 0:   # EPLB refresh interval
            stale = ema.value.copy() if s else lam.sum(0).astype(float)
        row = {"step": s}
        for mode in MODES:
            est = (torch.from_numpy(stale).to(device) if mode == "eplb"
                   else None)
            p = bal.solve(lam_t, home, BalancerConfig(mode=mode, n_slot=2,
                                                      u_min=4),
                          lam_e_est=est, load_bound=int(lam.sum()))
            row[mode] = metrics.imbalance(p.u.sum(0))
        row["pre"] = metrics.imbalance(np.bincount(home_np,
                                                   weights=lam.sum(0),
                                                   minlength=R))
        ema.update(lam.sum(0))
        rows.append(row)
        print(f"{s:4d} {row['pre']:6.2f} {row['eplb']:6.2f} "
              f"{row['eplb_plus']:6.2f} {row['ultraep']:8.2f}")
    return rows


if __name__ == "__main__":
    main()
