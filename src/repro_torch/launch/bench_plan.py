"""Time the plan-solve kernel on the card, one JSON line a case.

The cases are chip_smoke's rows P and Pk: E 128 and E 256 at R 64, top-8,
4096 tokens a rank, Zipf 1.0 expert popularity over a shuffled order (the
same seeds), flat and at rack size 8, at each ``--probes`` P.  Each line
holds the kernel's CUDA-graph device time (median of ``--repeats``
graphs), its (probes, steps) and, where the package has it, the critical
path, and a hash of the solved u, so two checkouts can be held to the same
plan.  ``probe_parallelism`` is passed only where P > 1, so a checkout
whose kernel predates it times its P 1.

The script imports the package from ``sys.path``, so pointing PYTHONPATH
at another checkout's ``src`` times that checkout's kernel with the same
cases (a parent and a change in one call, on one card):

  PYTHONPATH=src python src/repro_torch/launch/bench_plan.py --probes 1 4 8

``--eplb``: time EPLB's placement kernel (``eplb_place``, chip_smoke's row
Pe) instead: E 128 and E 256 at R 64 and E 256 at R 256 (one expert a
rank, 8 ranks a lane), n_slot 2, ``max_rep`` R, on the
Zipf load of phase 2 (seed E), with each checkout's bound unit (the
parent's block reduction, or the longer of one step's two chains: the
argmin and the re-sum, the vote and the argmax) and a hash of ``hosted``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import time

import numpy as np
import torch

TOKENS = 4096
CASES = [(64, 128, 8, None), (64, 128, 8, 8), (64, 256, 8, None),
         (64, 256, 8, 8)]


def _lam(R, E, k, seed):
    """chip_smoke's ``_plan_lam`` with the Zipf law."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, E + 1)
    p = p[rng.permutation(E)]
    return np.stack([rng.multinomial(TOKENS * k, p / p.sum())
                     for _ in range(R)]).astype(np.int64)


def _graph_ms(fn, iters: int) -> float:
    """Device time of one call, from a CUDA graph of ``iters`` calls."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=s):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--probes", type=int, nargs="+", default=[1])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--tag", default="")
    ap.add_argument("--eplb", action="store_true")
    args = ap.parse_args(argv)
    if args.eplb:
        _bench_eplb(args)
        return
    from repro_torch.core import planner
    from repro_torch.kernels.plan_solve import ops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"tag": args.tag, "nvidia_smi": smi,
                      "source": ops.__file__}), flush=True)
    for R, E, k, L in CASES:
        lam = torch.from_numpy(_lam(R, E, k, seed=R * 10 + 1))
        home = torch.arange(E) // (E // R)
        lam_e = lam.sum(dim=0)
        ell = planner._rank_load(lam_e, home, R)
        rexp = planner._expert_order(lam_e, home, R)
        args_d = [t.cuda() for t in (lam_e, ell, home, rexp)]
        for P in args.probes:
            kw = dict(n_slot=2, u_min=1, max_replicas_per_expert=R,
                      load_bound=R * TOKENS * k, rack_size=L)
            if P > 1:
                kw["probe_parallelism"] = P
            stats = torch.zeros(2, dtype=torch.int32, device="cuda")
            u, tau = ops.plan_solve(*args_d, stats=stats, **kw)
            torch.cuda.synchronize()
            ms = sorted(_graph_ms(lambda: ops.plan_solve(*args_d, **kw), 5)
                        for _ in range(args.repeats))
            digest = hashlib.sha256(u.cpu().numpy().tobytes()).hexdigest()
            print(json.dumps({
                "tag": args.tag, "shape": [R, E, k], "rack_size": L,
                "probe_parallelism": P, "ms": ms[len(ms) // 2],
                "ms_all": ms, "probes_steps": stats.tolist(),
                "tau": int(tau), "u_sha256": digest[:16],
                "time": time.time()}), flush=True)


def _bench_eplb(args) -> None:
    from repro_torch.kernels.eplb_place import ops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    unit = {}
    if hasattr(ops, "block_reduce_ms"):
        unit["block_reduce_ms"] = min(ops.block_reduce_ms() for _ in range(3))
    print(json.dumps({"tag": args.tag, "nvidia_smi": smi,
                      "source": ops.__file__, **unit}), flush=True)
    k = 8
    for R, E in ((64, 128), (64, 256), (256, 256)):
        if hasattr(ops, "step_chain_ms"):
            runs = [ops.step_chain_ms(E, R, 2) for _ in range(3)]
            unit = {"argmin_resum_ms": min(r[0] for r in runs),
                    "vote_argmax_ms": min(r[1] for r in runs)}
        lam_e = torch.from_numpy(_lam(R, E, k, seed=E)).sum(dim=0).to(
            torch.float32).cuda()
        home = (torch.arange(E) // (E // R)).cuda()
        kw = dict(n_slot=2, max_rep=R)
        stats = torch.zeros(2, dtype=torch.int32, device="cuda")
        hosted = ops.eplb_place(lam_e, home, R, stats=stats, **kw)
        torch.cuda.synchronize()
        ms = sorted(_graph_ms(lambda: ops.eplb_place(lam_e, home, R, **kw), 5)
                    for _ in range(args.repeats))
        digest = hashlib.sha256(hosted.cpu().numpy().tobytes()).hexdigest()
        print(json.dumps({
            "tag": args.tag, "kernel": "eplb_place", "shape": [R, E, k],
            "ms": ms[len(ms) // 2], "ms_all": ms,
            "steps_placements": stats.tolist(), "hosted_sha256": digest[:16],
            **unit, "time": time.time()}), flush=True)


if __name__ == "__main__":
    main()
