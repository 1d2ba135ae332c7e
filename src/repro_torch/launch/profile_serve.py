"""Where the serving time goes: one traced prefill chunk and decode step.

Builds ``--arch`` (GLM-4.5-Air by default) with its published widths and
``--layers`` layers (bf16, random weights from a seeded CUDA generator),
warms up, then traces one full prefill chunk and one decode step of a batch
with ``torch.profiler`` and prints, per step, one JSON line: the host wall
time between device synchronisations, the device-busy time (sum of kernel
times on the one stream), the idle share, the time per kernel category and
the top kernels.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve --layers 2
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \
      --arch jamba-v0.1-52b --layers 8
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --layers 2 \
      --wire-dtype int8 --ffn-dtype int8
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \
      --arch qwen3-235b-a22b --layers 2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.balancer import BalancerConfig
from repro_torch.core.quantize import FFN_DTYPES, WIRE_DTYPES
from repro_torch.models.model import init_lm
from repro_torch.models.transformer import ParallelCtx, RuntimeConfig
from repro_torch.serving.adapter import make_engine_fns

__all__ = ["main"]

# Kernel-name fragments -> category, first match wins.
_CATEGORIES = (
    ("grouped_gemm (ours)", ("grouped_gemm_wgmma_kernel", "grouped_gemm_f32")),
    ("grouped_gemm_q8 (ours)", ("grouped_gemm_q8_kernel",)),
    ("ssd_scan (ours)", ("ssd_intra_chunk_kernel",)),
    ("gating_topk (ours)", ("gating_topk_kernel",)),
    ("flash_attention (ours)", ("flash_wgmma_kernel", "flash_split_kernel",
                                "flash_combine_kernel", "flash_fwd_kernel")),
    ("library GEMM", ("gemm", "xmma", "cutlass", "cublas", "sm90_", "sm80_")),
    ("sort/scan/search", ("sort", "scan", "cumsum", "search", "radix")),
    ("gather/scatter/index", ("index", "gather", "scatter", "take")),
    ("elementwise/reduce/copy", ("elementwise", "reduce", "copy", "fill",
                                 "cat", "where", "softmax")),
)


def _category(name: str) -> str:
    low = name.lower()
    for cat, keys in _CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        val = getattr(evt, attr, None)
        if val is not None:
            return float(val)
    return 0.0


def _trace(step, label: str, top: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).endswith("CUDA") and _device_us(evt):
            kernels[evt.key] = (_device_us(evt) / 1e3, evt.count)
    busy = sum(ms for ms, _ in kernels.values())
    cats: dict[str, float] = {}
    for name, (ms, _) in kernels.items():
        cats[_category(name)] = cats.get(_category(name), 0.0) + ms
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]
    return {"step": label, "wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "categories_ms": dict(sorted(cats.items(), key=lambda kv: -kv[1])),
            "top_kernels": [{"name": n[:90], "ms": ms, "calls": c}
                            for n, (ms, c) in ranked]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="glm45-106b-a12b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--chunk", type=int, default=4096)
    ap.add_argument("--decode-batch", type=int, default=4)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--wire-dtype", default="none", choices=WIRE_DTYPES)
    ap.add_argument("--ffn-dtype", default="none", choices=FFN_DTYPES)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(args.arch), num_layers=args.layers)
    rcfg = RuntimeConfig(balancer=BalancerConfig(mode="ultraep",
                                                 n_slot=cfg.moe.n_slot),
                         cf_pair=4.0, cf_slot=4.0, dtype=torch.bfloat16,
                         wire_dtype=args.wire_dtype, ffn_dtype=args.ffn_dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_lm(cfg, rcfg, ParallelCtx(), gen, device="cuda")
    prefill, decode, new_cache, stack, _ = make_engine_fns(
        params, cfg, rcfg, ParallelCtx(), max_seq=2 * args.chunk + 16)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(
        1, args.chunk)).astype(np.int32))
    _, cache = prefill(toks, new_cache(1), 0, args.chunk)       # warm-up
    caches = stack([cache] * args.decode_batch)
    step_toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(
        args.decode_batch, 1)).astype(np.int32))
    decode(step_toks, caches)                                    # warm-up
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "arch": cfg.name, "layers": args.layers,
                      "chunk": args.chunk, "wire_dtype": args.wire_dtype,
                      "ffn_dtype": args.ffn_dtype,
                      "decode_batch": args.decode_batch}), flush=True)
    print(json.dumps(_trace(lambda: prefill(toks, cache, args.chunk,
                                            args.chunk),
                            f"prefill_chunk_at_{args.chunk}", args.top)),
          flush=True)
    print(json.dumps(_trace(lambda: decode(step_toks, caches), "decode_step",
                            args.top)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
