"""Where the serving time goes: one traced prefill chunk and decode step.

Builds ``--arch`` (GLM-4.5-Air by default) with its published widths and
``--layers`` layers (``--dtype``, bf16 by default, random weights from a
seeded CUDA generator),
warms up, then traces one full prefill chunk and one decode step of a batch
with ``torch.profiler`` and prints, per step, one JSON line: the host wall
time between device synchronisations, the device-busy time (sum of kernel
times on the one stream), the idle share, the time per kernel category,
the top kernels, and the device time of the plain int8 codec (from a
second traced run with a profiler range around each codec call).

  PYTHONPATH=src python -m repro_torch.launch.profile_serve --layers 2
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \
      --arch jamba-v0.1-52b --layers 8
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --layers 2 \
      --wire-dtype int8 --ffn-dtype int8
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \
      --arch qwen3-235b-a22b --layers 2
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --layers 2 \
      --dtype float32
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \
      --arch deepseek-v3-671b --layers 4      # 3 dense + 1 MoE layer, MLA
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
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
    ("grouped_gemm_q8 (ours)", ("grouped_gemm_q8_wgmma_kernel",)),
    ("grouped_gemm backward (ours)", ("grouped_wgrad_kernel",
                                      "grouped_swiglu_bwd_kernel",
                                      "grouped_matmul_nt_kernel")),
    ("flash_attention backward (ours)", ("bwd_dkdv_kernel", "bwd_dq_kernel",
                                         "bwd_prep_kernel",
                                         "bwd_dkdv_split_kernel",
                                         "bwd_dq_gemm_kernel")),
    ("ssd_scan backward (ours)", ("ssd_bwd_kernel",)),
    ("grouped_gemm (ours)", ("grouped_gemm_wgmma_kernel",
                             "grouped_gemm_tf32_kernel")),
    ("ssd_scan (ours)", ("ssd_intra_chunk_kernel",)),
    ("gating_topk (ours)", ("gating_topk_kernel",)),
    ("flash_attention (ours)", ("flash_wgmma_kernel", "flash_split_kernel",
                                "flash_combine_kernel", "flash_fwd_kernel",
                                "flash_fwd_f32_kernel")),
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


def _codec_functions() -> dict:
    """The plain int8 codec, by identity: every function that
    ``repro_torch.core.quantize`` exports, and the weight quantizer."""
    from repro_torch.core import quantize
    from repro_torch.moe.expert import quantize_weight_cols

    fns = [getattr(quantize, name) for name in quantize.__all__]
    return {id(f): f for f in fns + [quantize_weight_cols] if callable(f)}


def _ranged(fn):
    """``fn`` inside a ``record_function("int8_codec")`` range."""
    def ranged(*args, **kwargs):
        with torch.profiler.record_function("int8_codec"):
            return fn(*args, **kwargs)

    return ranged


@contextlib.contextmanager
def _codec_ranges():
    """While the block runs, every name bound to a codec function in a
    loaded ``repro_torch`` module (its own module's included) calls it
    inside an ``int8_codec`` range, however the caller imported it (the
    port itself carries no ranges)."""
    codec = _codec_functions()
    saved = []
    for name, mod in list(sys.modules.items()):
        if mod is None or not name.startswith("repro_torch"):
            continue
        for attr, fn in list(vars(mod).items()):
            if codec.get(id(fn)) is fn:
                saved.append((mod, attr, fn))
    for mod, attr, fn in saved:
        setattr(mod, attr, _ranged(fn))
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def _codec_ms(step) -> float:
    """Device time of the kernels launched inside the int8 codec's ranges in
    one more traced run of ``step`` (its host time is not reported: the
    ranges add host work)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with _codec_ranges(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()

    def nested(evt) -> bool:
        p = evt.cpu_parent
        while p is not None:
            if p.name == "int8_codec":
                return True
            p = p.cpu_parent
        return False

    # The host-side ranges (the profiler also lists each range's span on
    # the device, gaps included, as an event of the same name): each one's
    # device time is that of the kernels launched inside it.
    return sum(e.device_time_total for e in prof.events()
               if e.name == "int8_codec" and e.device_type.name == "CPU"
               and not nested(e)) / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="glm45-106b-a12b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--chunk", type=int, default=4096)
    ap.add_argument("--decode-batch", type=int, default=4)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--wire-dtype", default="none", choices=WIRE_DTYPES)
    ap.add_argument("--ffn-dtype", default="none", choices=FFN_DTYPES)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(args.arch), num_layers=args.layers)
    rcfg = RuntimeConfig(balancer=BalancerConfig(mode="ultraep",
                                                 n_slot=cfg.moe.n_slot),
                         cf_pair=4.0, cf_slot=4.0,
                         dtype=getattr(torch, args.dtype),
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
                      "ffn_dtype": args.ffn_dtype, "dtype": args.dtype,
                      "decode_batch": args.decode_batch}), flush=True)
    steps = ((f"prefill_chunk_at_{args.chunk}",
              lambda: prefill(toks, cache, args.chunk, args.chunk)),
             ("decode_step", lambda: decode(step_toks, caches)))
    for label, step in steps:
        rec = _trace(step, label, args.top)
        rec["int8_codec_ms"] = _codec_ms(step)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
