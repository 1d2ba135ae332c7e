#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root, one card

Phases, one output line each:
  1. card, torch/CUDA versions, kernel build (nvcc, sm_90a) time;
  2. every kernel of the serving path against its plain PyTorch version at
     the main path's prefill and decode shapes and at ragged shapes, in bf16
     (max|err| <= 1e-2 max|ref|: one bf16 rounding of the output) and fp32
     (max|err| <= 1e-4 max|ref|: summation order), with the kernel's, the
     plain version's and a library call's time and the card's bound;
  3. the balanced MoE layer at GLM-4.5-Air width (T 4096, ep_size 1) in the
     a2a and replicated modes against the dense oracle ``moe_ref`` in fp32
     (bf16 layer: 2e-2 max|ref|, fp32 layer: 1e-4 max|ref|), zero drops;
  4. ``serve_trace`` on GLM-4.5-Air at every published width with depth cut
     to 2 layers, bf16 weights from a seeded CUDA generator: 4 requests of
     2048-6144 tokens, chunk 4096, 8 new tokens each, decode batch 4,
     balancer ultraep, capacity factors 4.0;
  5. the kernels of the path with their launch counts during phase 4.

TF32 is off for matmuls and cuDNN, so fp32 references are full fp32.  Any
failed check raises and the script exits non-zero; the last line is the
``{"ok": true, "device": ...}`` record.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12                     # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {"bf16": 989e12, "fp32": 67e12}   # dense, no sparsity
PREFILL = dict(G=130, M=1009, K=4096, N=1408)      # 128 mains + 2 replicas
DECODE = dict(G=130, M=8, K=4096, N=1408)


def _line(tag: str, payload) -> None:
    print(f"{tag} {json.dumps(payload)}", flush=True)


def _cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _bound(flops: float, nbytes: float, kind: str) -> tuple[float, str]:
    t_ops = flops / PEAK_OPS_PER_S[kind]
    t_mem = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


def _max_err(out, ref) -> tuple[float, float]:
    return ((out.float() - ref.float()).abs().max().item(),
            ref.float().abs().max().item())


def phase_card():
    import torch

    from repro_torch.kernels.build import build_all

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    logs = build_all()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    _line("phase1_card", {
        "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": sys.version.split()[0], "tf32": False,
        "kernel_build_s": round(build_s, 3), "ptxas": ptxas})


def _kernel_inputs(G, M, K, N, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def n(shape, scale):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)

    return (n((G, M, K), 1.0), n((G, K, N), K ** -0.5), n((G, K, N), K ** -0.5),
            n((G, N, K), N ** -0.5))


def _check_case(name, fn, ref, tol):
    import torch

    out = fn()
    torch.cuda.synchronize()
    expect = ref()
    err, scale = _max_err(out, expect)
    if not err <= tol * scale:
        raise AssertionError(f"{name}: max|err| {err:.3e} > {tol} * "
                             f"max|ref| {scale:.3e}")
    return err, scale


def _time_pair(kernel, plain, library, flops, nbytes, kind, iters):
    ms = _cuda_ms(kernel, iters)
    plain_ms = _cuda_ms(plain, max(1, iters // 2))
    library_ms = _cuda_ms(library, iters)
    bound_ms, bound_by = _bound(flops, nbytes, kind)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_kernels() -> dict:
    """Both kernels vs their plain versions; returns the records by name."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.grouped_gemm import ops

    records = {"grouped_swiglu": {}, "grouped_matmul": {}}
    cases = [("prefill", PREFILL, torch.bfloat16, 10),
             ("decode", DECODE, torch.bfloat16, 20),
             ("fp32_g8", dict(PREFILL, G=8), torch.float32, 3),
             ("ragged_m1", dict(G=1, M=1, K=4096, N=1408), torch.bfloat16, 0),
             ("ragged_tiles", dict(G=3, M=1009, K=136, N=200), torch.bfloat16, 0),
             ("ragged_small", dict(G=2, M=65, K=33, N=129), torch.bfloat16, 0),
             ("ragged_m1_fp32", dict(G=1, M=1, K=70, N=45), torch.float32, 0),
             ("ragged_tiles_fp32", dict(G=3, M=1009, K=136, N=200),
              torch.float32, 0)]
    for tag, s, dtype, iters in cases:
        G, M, K, N = s["G"], s["M"], s["K"], s["N"]
        x, w1, w3, w2 = _kernel_inputs(G, M, K, N, dtype, seed=len(tag))
        kind = "bf16" if dtype == torch.bfloat16 else "fp32"
        tol = 1e-2 if kind == "bf16" else 1e-4
        elt = x.element_size()
        act = ops.grouped_swiglu(x, w1, w3)
        sw = dict(zip(("max_abs_err", "max_abs_ref"), _check_case(
            f"grouped_swiglu {tag}", lambda: act,
            lambda: ops.grouped_swiglu_ref(x, w1, w3), tol)))
        mm = dict(zip(("max_abs_err", "max_abs_ref"), _check_case(
            f"grouped_matmul {tag}", lambda: ops.grouped_matmul(act, w2),
            lambda: ops.grouped_matmul_ref(act, w2), tol)))
        if iters:
            sw.update(_time_pair(
                lambda: ops.grouped_swiglu(x, w1, w3),
                lambda: ops.grouped_swiglu_ref(x, w1, w3),
                lambda: F.silu(torch.bmm(x, w1)) * torch.bmm(x, w3),
                4.0 * G * M * K * N, (G * M * K + 2 * G * K * N + G * M * N) * elt,
                kind, iters))
            mm.update(_time_pair(
                lambda: ops.grouped_matmul(act, w2),
                lambda: ops.grouped_matmul_ref(act, w2),
                lambda: torch.bmm(act, w2),
                2.0 * G * M * N * K, (G * M * N + G * N * K + G * M * K) * elt,
                kind, iters))
        records["grouped_swiglu"][tag] = dict(shape=[G, M, K, N], dtype=kind, **sw)
        records["grouped_matmul"][tag] = dict(shape=[G, M, N, K], dtype=kind, **mm)
        del x, w1, w3, w2, act
        torch.cuda.empty_cache()
    _line("phase2_kernels", records)
    return records


def phase_moe_layer(glm):
    """The balanced layer at full width vs the dense oracle in fp32."""
    import torch

    from repro_torch.moe.gating import gate
    from repro_torch.moe.layer import MoEParams, init_moe_params, moe_layer_local
    from repro_torch.moe.reference import moe_ref
    from repro_torch.models.transformer import (
        ParallelCtx,
        RuntimeConfig,
        moe_config,
    )

    T = 4096
    rcfg = RuntimeConfig(cf_pair=4.0, cf_slot=4.0, dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg_a2a = moe_config(glm, rcfg, ParallelCtx(), T)
    p16 = init_moe_params(cfg_a2a, gen, dtype=torch.bfloat16, device="cuda")
    x16 = torch.randn((T, glm.d_model), generator=gen, device="cuda"
                      ).to(torch.bfloat16)
    p32 = MoEParams(p16.router, *(w.float() for w in (
        p16.w1, p16.w3, p16.w2, p16.shared_w1, p16.shared_w3, p16.shared_w2)),
        n_slot=p16.n_slot)
    x32 = x16.float()
    result = {}
    with torch.inference_mode():
        go = gate(x32, p32.router, cfg_a2a.gating)
        ref = moe_ref(x32, go.expert_ids, go.weights, p32.w1, p32.w3, p32.w2,
                      shared=(p32.shared_w1, p32.shared_w3, p32.shared_w2))
        for mode, params, x, tol in (("a2a", p32, x32, 1e-4),
                                     ("a2a", p16, x16, 2e-2),
                                     ("replicated", p16, x16, 2e-2)):
            cfg = dataclasses.replace(cfg_a2a, dispatch_mode=mode)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y, aux, st = moe_layer_local(x, params, cfg)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            err, scale = _max_err(y, ref)
            key = f"{mode}_{'fp32' if x.dtype == torch.float32 else 'bf16'}"
            drops = int(st.drops_dispatch) + int(st.drops_slot)
            if drops or int(st.counts.sum()) != T * cfg.gating.top_k:
                raise AssertionError(f"moe layer {key}: drops {drops}, "
                                     f"counts {int(st.counts.sum())}")
            if not (torch.isfinite(y).all() and err <= tol * scale):
                raise AssertionError(f"moe layer {key}: max|err| {err:.3e} > "
                                     f"{tol} * max|ref| {scale:.3e}")
            result[key] = {"max_abs_err": err, "max_abs_ref": scale, "tol": tol,
                           "wall_ms": wall_ms, "pre_max": int(st.pre_max),
                           "post_max": int(st.post_max),
                           "max_slot_load": int(st.max_slot_load),
                           "cap_slot": cfg.cap_slot, "cap_pair": cfg.cap_pair}
    _line("phase3_moe_layer", result)
    del p16, p32, x16, x32, ref, go
    torch.cuda.empty_cache()


def phase_serve(glm):
    import torch

    from repro_torch.kernels.grouped_gemm import ops
    from repro_torch.launch.serve import serve_trace

    cfg = dataclasses.replace(glm, name=glm.name + "-2l", num_layers=2)
    torch.cuda.reset_peak_memory_stats()
    ops.grouped_swiglu.launches = 0      # counts from here on are the path's
    ops.grouped_matmul.launches = 0
    eng = serve_trace(cfg, requests=4, chunk=4096, max_new=8, reduce=False,
                      balancer="ultraep", seed=0, prompt_len=(2048, 6144),
                      decode_batch=4, cf=4.0, dtype=torch.bfloat16,
                      device="cuda")
    launches = {"grouped_swiglu": ops.grouped_swiglu.launches,
                "grouped_matmul": ops.grouped_matmul.launches}
    done = eng.finished
    failed = [r.rid for r in done if r.failed]
    if len(done) != 4 or failed or eng.fault_counters["nonfinite_logits"]:
        raise AssertionError(f"serve: finished {len(done)}, failed {failed}, "
                             f"faults {eng.fault_counters}, last error "
                             f"{eng.last_error!r}")
    if any(len(r.output) != 8 for r in done):
        raise AssertionError("serve: a request did not produce 8 tokens")
    pre = [(n, s) for kind, n, s in eng.calls if kind == "prefill"]
    dec = [(n, s) for kind, n, s in eng.calls if kind == "decode"]
    _line("phase4_serve", {
        "model": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "experts": cfg.moe.num_experts, "top_k": cfg.moe.top_k,
        "prompt_tokens": [len(r.prompt) for r in sorted(done, key=lambda r: r.rid)],
        "prefill_calls": len(pre), "decode_calls": len(dec),
        "prefill_tok_per_s": sum(n for n, _ in pre) / sum(s for _, s in pre),
        "decode_tok_per_s": sum(n for n, _ in dec) / sum(s for _, s in dec),
        "prefill_call_s": [s for _, s in pre], "decode_call_s": [s for _, s in dec],
        "mean_ttft_s": float(eng.ttft().mean()),
        "mean_tpot_s": float(eng.tpot().mean()),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches})
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to measure", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config

    t_start = time.perf_counter()
    phase_card()
    records = phase_kernels()
    glm = get_config("glm45-106b-a12b")
    phase_moe_layer(glm)
    launches = phase_serve(glm)
    sources = {"grouped_swiglu": "src/repro/kernels/grouped_gemm/kernel.py:154",
               "grouped_matmul": "src/repro/kernels/grouped_gemm/kernel.py:184"}
    kernels = []
    for name in ("grouped_swiglu", "grouped_matmul"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the serve path")
        main_rec = records[name]["prefill"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/grouped_gemm/csrc/grouped_gemm.cu",
            "replaces": sources[name], "launches": launches[name],
            "max_abs_err": main_rec["max_abs_err"], "ms": main_rec["ms"],
            "plain_ms": main_rec["plain_ms"], "bound_ms": main_rec["bound_ms"],
            "bound_by": main_rec["bound_by"],
            "library_ms": main_rec["library_ms"], "shape": main_rec["shape"],
            "decode": {k: records[name]["decode"][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_err")},
            "checks": sorted(records[name])})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"total_s {time.perf_counter() - t_start:.1f}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
