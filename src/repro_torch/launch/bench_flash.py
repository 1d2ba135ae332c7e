"""Time the flash attention kernels on the card, one JSON line a case.

``--plan``: both candidate kernels of ``ops.plan_launch`` (the prefill
kernel, planned for a card of one SM, and the split-KV kernel with the
splits the plan gives it on this card, ``ops.PREFILL_FILL`` set above any
grid for the call) on each case, with the plan's own pick and its q-tile grid
beside, as CUDA-graph device times.  The cases sweep grids around
``ops.PREFILL_FILL`` of the SMs in GQA 4 at hd 128 (GLM-4.5-Air's heads)
and in MLA's (192, 128) at G 1, take the plan rows of
``tests/test_torch_flash_attention.py`` that sit near the threshold, and
each serve path's flash shapes (chunk 4096 at offset 4096, decode at
batch 4), with GLM decode at batch 8 and 16 beside (grids 64 and 128).

``--fwd``: the plan's pick at GLM-4.5-Air's serve chunk (4096 queries at
offset 4096 over a 10,248-position cache; in bf16 and in fp32) and at
DeepSeek-V3's 64- and 128-query MLA chunks.  ``--bwd``: ``flash_attention_bwd`` at the train
step's shape (B 2, S 4096, 32 / 8 heads, hd 128, causal) and at
DeepSeek-V3's train cell (B 1, S 4096, 128 heads, q/k 192, v 128, MLA's
scale), eager events over repeated calls, beside SDPA's backward (flash
backend; memory-efficient at (192, 128), where flash takes one head dim),
each of its three kernels timed alone with CUDA events
(``ops.bwd_stage_ms``) and the device time of each kernel from
``torch.profiler``; with ``--check`` it also asserts that two calls give
the same bits.  It then times the mma.sync backward (``mma_f32``,
``mma_bf16``: ``csrc/flash_attention_bwd_mma.cu``) at the trainer's
defaults: fp32 at B 1, S 2048, 16 / 4 heads (chip_smoke's B4F_SHAPE) at
every head-dim pair, causal, and (128, 128) and (192, 128) bidirectional
too, the Qwen3-0.6B command line's own shape (B 8, S 128, 16 / 8 heads,
(128, 128), causal), and bf16 at (16, 16); each beside SDPA's backward
(fp32: memory-efficient; bf16: flash) and its kernels alone.

``--parent ROOT`` (with ``--bwd``): also builds ROOT's
``flash_attention_bwd_mma.cu`` (another checkout, with its own shared
headers) and times it through the same C entry point on the same inputs,
in turns (parent, change, change, parent); ``--check`` then asserts that
each library gives the same bits on two calls and that each is within
1e-4 (fp32; bf16 2e-2) of each of dq, dk, dv's max|ref| against the
plain version.  The two sum in other orders, so they are not compared
bit for bit.

The script imports the package from ``sys.path``, so pointing PYTHONPATH
at another checkout's ``src`` times that checkout's kernels with the same
cases (a parent and a change in one call, on one card):

  PYTHONPATH=src python src/repro_torch/launch/bench_flash.py --fwd --bwd
  PYTHONPATH=src python src/repro_torch/launch/bench_flash.py --bwd \
      --parent build/parent --check
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
from pathlib import Path

import torch

SERVE_SK = 6144 + 8 + 4096          # chip_smoke's serve cache capacity


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


def _event_ms(fn, iters: int) -> float:
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


def _inputs(B, Sq, Sk, H, Hkv, hd, hd_v, q_off, kv_len, seed=0,
            dtype=torch.bfloat16):
    g = torch.Generator(device="cuda").manual_seed(seed)
    bf = dtype
    q = torch.randn((B, Sq, H, hd), generator=g, device="cuda").to(bf)
    k = torch.randn((B, Sk, Hkv, hd), generator=g, device="cuda").to(bf)
    # MLA's v is the last 128 columns of the expanded latent: a view.
    v = torch.randn((B, Sk, Hkv, hd if hd_v == hd else 2 * hd_v),
                    generator=g, device="cuda").to(bf)[..., -hd_v:]
    return (q, k, v, torch.tensor(q_off, device="cuda"),
            torch.tensor(kv_len, device="cuda"))


def _plan_cases():
    """(tag, B, Sq, Sk, H, Hkv, (hd, hd_v), q_offset, kv_valid_len)."""
    cases = []
    for tiles in (8, 10, 12, 13, 14, 16, 24):       # grid = tiles x 8 KV heads
        Sq = 32 * tiles
        cases.append((f"gqa4_grid{8 * tiles}", 1, Sq, SERVE_SK, 32, 8,
                      (128, 128), [4096], [4096 + Sq]))
    for H in (64, 80, 96, 112, 128):                 # grid = H (one q tile)
        cases.append((f"mla_h{H}_q64", 1, 64, SERVE_SK, H, H, (192, 128),
                      [4096], [4160]))
    cases += [
        ("mla_q16", 1, 16, SERVE_SK, 128, 128, (192, 128), [4096], [4112]),
        ("mla_q128", 1, 128, SERVE_SK, 128, 128, (192, 128), [4096],
         [4224]),
        ("plan_mla_q64_sk8192", 1, 64, 8192, 128, 128, (192, 128), [8128],
         [8192]),
        ("plan_gqa4_grid98", 1, 1568, 4096, 8, 2, (128, 128), [0], [4096]),
        ("plan_gqa4_grid99", 1, 1056, 4096, 12, 3, (128, 128), [0], [4096]),
        ("glm_prefill_at_4096", 1, 4096, SERVE_SK, 32, 8, (128, 128),
         [4096], [8192]),
        ("qwen3_prefill_at_4096", 1, 4096, SERVE_SK, 64, 4, (128, 128),
         [4096], [8192]),
        ("mla_prefill_at_4096", 1, 4096, SERVE_SK, 128, 128, (192, 128),
         [4096], [8192]),
        ("glm_decode", 4, 1, SERVE_SK, 32, 8, (128, 128), [0] * 4,
         [2048, 6144, 3000, 1]),
        ("qwen3_decode", 4, 1, SERVE_SK, 64, 4, (128, 128), [0] * 4,
         [2048, 6144, 3000, 1]),
        ("glm_decode_b8", 8, 1, SERVE_SK, 32, 8, (128, 128), [0] * 8,
         [2048, 6144, 3000, 1] * 2),
        ("glm_decode_b16", 16, 1, SERVE_SK, 32, 8, (128, 128), [0] * 16,
         [2048, 6144, 3000, 1] * 4),
    ]
    return cases


def bench_plan(iters: int) -> None:
    from repro_torch.kernels.flash_attention import ops

    sms = ops._sm_count(torch.device("cuda"))
    for tag, B, Sq, Sk, H, Hkv, (hd, hd_v), q_off, kv_len in _plan_cases():
        q, k, v, off, lim = _inputs(B, Sq, Sk, H, Hkv, hd, hd_v, q_off, kv_len)
        causal = Sq > 1
        G = H // Hkv
        grid = -(-Sq // max(1, ops.TILE_ROWS["prefill_wgmma"] // G)) * Hkv * B
        rec = {"case": tag, "shape": [B, Sq, Sk, H, Hkv, hd, hd_v],
               "grid": grid, "sms": sms,
               "plan": ops.plan_launch(B, Sq, Sk, H, Hkv, hd, q.dtype,
                                       sms).kernel}
        for name, force, fill in (("prefill_ms", 1, ops.PREFILL_FILL),
                                  ("split_ms", sms, float("inf"))):
            saved, ops.PREFILL_FILL = ops.PREFILL_FILL, fill
            try:
                ran = ops._launch(q, k, v, causal, off, lim, None,
                                  sms=force)[1]
                rec[name] = _graph_ms(
                    lambda: ops._launch(q, k, v, causal, off, lim, None,
                                        sms=force), iters)
            finally:
                ops.PREFILL_FILL = saved
            rec[name.replace("_ms", "_kernel")] = ran
        rec["faster"] = ("prefill" if rec["prefill_ms"] < rec["split_ms"]
                         else "split")
        print(json.dumps(rec), flush=True)
        del q, k, v
        torch.cuda.empty_cache()


def bench_fwd(iters: int) -> None:
    from repro_torch.kernels.flash_attention import ops

    f32 = torch.float32
    for tag, B, Sq, Sk, H, Hkv, (hd, hd_v), q_off, kv_len, *dtype in [
            ("glm_prefill_at_4096", 1, 4096, SERVE_SK, 32, 8, (128, 128),
             [4096], [8192]),
            ("glm_prefill_at_4096_fp32", 1, 4096, SERVE_SK, 32, 8,
             (128, 128), [4096], [8192], f32),
            ("mla_prefill_64", 1, 64, SERVE_SK, 128, 128, (192, 128), [4096],
             [4160]),
            ("mla_prefill_128", 1, 128, SERVE_SK, 128, 128, (192, 128),
             [4096], [4224])]:
        q, k, v, off, lim = _inputs(B, Sq, Sk, H, Hkv, hd, hd_v, q_off, kv_len,
                                    dtype=dtype[0] if dtype else torch.bfloat16)
        kw = dict(causal=True, q_offset=off, kv_valid_len=lim)
        before = dict(ops.flash_attention.launches_by_kernel)
        ops.flash_attention(q, k, v, **kw)
        ran = [n for n, c in ops.flash_attention.launches_by_kernel.items()
               if c != before[n]]
        print(json.dumps({"case": tag, "kernel": ran, "ms": _graph_ms(
            lambda: ops.flash_attention(q, k, v, **kw), iters)}), flush=True)


def _bwd_cases():
    """(tag, B, S, H, Hkv, hd, hd_v, scale, SDPA backend name): B4 at the
    GLM train step, B4m at DeepSeek-V3's train cell (k and v strided
    views of one tensor, as MLA makes them)."""
    return [("train_step_flash_bwd", 2, 4096, 32, 8, 128, 128, None,
             "FLASH_ATTENTION"),
            ("mla_train_cell_flash_bwd", 1, 4096, 128, 128, 192, 128,
             192 ** -0.5, "EFFICIENT_ATTENTION")]


def bench_bwd(iters: int, check: bool) -> None:
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import ops

    for tag, B, S, H, Hkv, hd, hd_v, scale, backend in _bwd_cases():
        g = torch.Generator(device="cuda").manual_seed(12)
        q, dout = (torch.randn((B, S, H, d), generator=g, device="cuda")
                   .to(torch.bfloat16) for d in (hd, hd_v))
        kv = torch.randn((B, S, Hkv, hd + hd_v), generator=g,
                         device="cuda").to(torch.bfloat16)
        k, v = kv[..., :hd], kv[..., hd:]
        if scale is None:           # GQA's k and v are tensors of their own
            k, v = k.contiguous(), v.contiguous()
        lse = torch.empty((B, H, S), device="cuda")
        o = ops._launch(q, k, v, True, 0, None, scale, sms=1, lse=lse)[0]

        def kernel():
            return ops.flash_attention_bwd(q, k, v, o, dout, lse,
                                           causal=True, scale=scale)

        rec = {"case": tag, "shape": [B, S, H, Hkv, hd, hd_v]}
        if check:
            first, again = kernel(), kernel()
            if not all(torch.equal(a, b) for a, b in zip(first, again)):
                raise AssertionError(f"{tag}: two calls differ")
            rec["bitwise_equal"] = True
            del first, again
        qt = q.transpose(1, 2).detach().requires_grad_(True)
        kt, vt = (t.repeat_interleave(H // Hkv, dim=2).transpose(1, 2)
                  .detach().requires_grad_(True) for t in (k, v))
        with sdpa_kernel([getattr(SDPBackend, backend)]):
            ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                scale=scale)
        dot = dout.transpose(1, 2)
        for _ in range(2):      # kernel, library, kernel, library
            rec.setdefault("ms", []).append(_event_ms(kernel, iters))
            rec.setdefault("sdpa_bwd_ms", []).append(_event_ms(
                lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                            retain_graph=True), iters))
        rec["sdpa_backend"] = backend
        if hasattr(ops, "bwd_stage_ms"):     # absent before the split
            rec["stage_ms"] = ops.bwd_stage_ms(q, k, v, o, dout, lse,
                                               causal=True, scale=scale,
                                               iters=iters)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                kernel()
            torch.cuda.synchronize()
        rec["kernel_ms"] = {
            e.key[:60]: e.device_time_total / 1e3 / iters
            for e in prof.key_averages() if e.device_time_total > 0}
        print(json.dumps(rec), flush=True)
        del q, k, v, kv, dout, o, lse, qt, kt, vt, ot
        torch.cuda.empty_cache()


def _bwd_mma_cases():
    """(tag, B, S, H, Hkv, hd, hd_v, causal, dtype) of the mma.sync
    backward: chip_smoke's B4F_SHAPE at each pair, the Qwen3-0.6B command
    line's shape, bf16 at hd 16."""
    f32, bf = torch.float32, torch.bfloat16
    cases = [(f"b4f_{hd}x{hv}_causal", 1, 2048, 16, 4, hd, hv, True, f32)
             for hd, hv in ((16, 16), (64, 64), (80, 80), (128, 128),
                            (192, 128))]
    cases += [(f"b4f_{hd}x{hv}_bidir", 1, 2048, 16, 4, hd, hv, False, f32)
              for hd, hv in ((128, 128), (192, 128))]
    cases += [("b4f_qwen3_0.6b_main", 8, 128, 16, 8, 128, 128, True, f32),
              ("b4_bf16_16x16_causal", 1, 2048, 16, 4, 16, 16, True, bf)]
    return cases


def _mma_entry(root: Path | None):
    """The C entry point of ROOT's ``flash_attention_bwd_mma.cu`` (None:
    this checkout's), argument types set, and whether it takes the dK/dV
    pass's per-head partials workspace (a source with the group-sum
    kernel; older ones take none)."""
    from repro_torch.kernels.build import KernelLibrary
    from repro_torch.kernels.flash_attention import ops

    if root is None:
        return ops._bwd_mma_launcher(), True
    kdir = root / "src" / "repro_torch" / "kernels"
    src = kdir / "flash_attention" / "csrc" / "flash_attention_bwd_mma.cu"
    lib = KernelLibrary("flash_attention_bwd_mma_parent", src,
                        include=kdir / "csrc")
    fn = lib.load().flash_attention_bwd_mma_launch
    fn.restype = ops._bwd_mma_launcher().restype
    fn.argtypes = ops._bwd_mma_launcher().argtypes
    return fn, "bwd_group_sum_kernel" in src.read_text()


def bench_bwd_mma(iters: int, check: bool, parent: Path | None,
                  rounds: int = 2) -> None:
    """The mma.sync backward at ``_bwd_mma_cases``: each library (this
    checkout's, and ROOT's with ``parent``) called through its C entry on
    the same operands, timed in turns, beside SDPA's backward; the
    change's kernels alone (``ops.bwd_stage_ms``)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import ops

    libs = {"change": _mma_entry(None)}
    if parent is not None:
        libs = {"parent": _mma_entry(parent), **libs}
    takes_part = {who: e[1] for who, e in libs.items()}
    libs = {who: e[0] for who, e in libs.items()}
    for tag, B, S, H, Hkv, hd, hv, causal, dtype in _bwd_mma_cases():
        g = torch.Generator(device="cuda").manual_seed(19)
        q = torch.randn((B, S, H, hd), generator=g, device="cuda").to(dtype)
        k = torch.randn((B, S, Hkv, hd), generator=g, device="cuda").to(dtype)
        v = torch.randn((B, S, Hkv, hv), generator=g, device="cuda").to(dtype)
        dout = torch.randn((B, S, H, hv), generator=g,
                           device="cuda").to(dtype)
        lse = torch.empty((B, H, S), device="cuda")
        o = ops._launch(q, k, v, causal, 0, None, None, sms=1, lse=lse)[0]
        opnds = {who: ops._bwd_operands(q, k, v, o, dout, lse, causal)
                 for who in libs}
        for who in opnds:
            if not takes_part[who]:
                opnds[who] = (*opnds[who][:10], None)
        scale = hd ** -0.5

        def call(who):
            t = opnds[who]
            err = libs[who](
                ops._DTYPE_CODE[dtype],
                *(None if x is None else x.data_ptr() for x in t), B, S, H,
                Hkv, hd, hv, int(causal), scale, 7,
                *(x.stride(d) for x in (t[1], t[2]) for d in (2, 1, 0)),
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{tag} {who}: launch error {err}")

        rec = {"case": tag, "shape": [B, S, H, Hkv, hd, hv],
               "causal": causal, "dtype": str(dtype)[6:],
               "libraries": list(libs)}
        if check:
            tol = 1e-4 if dtype == torch.float32 else 2e-2
            refs = ops.flash_attention_bwd_ref(q, k, v, dout, causal=causal)
            rec["rel_err"] = {}
            for who in libs:
                call(who)
                first = [t.clone() for t in opnds[who][7:10]]
                call(who)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in
                           zip(first, opnds[who][7:10])):
                    raise AssertionError(f"{tag} {who}: two calls differ")
                errs = {}
                for n, a, r in zip("qkv", first, refs):
                    ref_max = r.float().abs().max().item()
                    errs[n] = (a.float() - r.float()).abs().max().item() / \
                        max(ref_max, 1e-30)
                    if not errs[n] <= tol:
                        raise AssertionError(f"{tag} {who} d{n}: {errs[n]:.3e}"
                                             f" of max|ref| > {tol}")
                rec["rel_err"][who] = errs
            rec["bitwise_two_calls"] = True
            del refs, first
        one = list(libs)
        order = []
        for r in range(rounds):
            order += (one + one[::-1]) if r % 2 == 0 else (one[::-1] + one)
        for who in libs:
            _event_ms(lambda: call(who), iters)
        times = {who: [] for who in libs}
        for who in order:
            times[who].append(_event_ms(lambda: call(who), iters))
        rec["ms"] = times
        rec["median_ms"] = {w: statistics.median(t) for w, t in times.items()}
        if "parent" in libs:
            rec["change_over_parent"] = (rec["median_ms"]["change"]
                                         / rec["median_ms"]["parent"])
        rec["stage_ms"] = ops.bwd_stage_ms(q, k, v, o, dout, lse,
                                           causal=causal, iters=iters)
        G = H // Hkv
        qt = q.transpose(1, 2).detach().requires_grad_(True)
        kt, vt = (t.repeat_interleave(G, dim=2).transpose(1, 2).detach()
                  .requires_grad_(True) for t in (k, v))
        backend = (SDPBackend.EFFICIENT_ATTENTION if dtype == torch.float32
                   else SDPBackend.FLASH_ATTENTION)
        with sdpa_kernel([backend]):
            ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        dot = dout.transpose(1, 2)
        rec["sdpa_bwd_ms"] = _event_ms(
            lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                        retain_graph=True), iters)
        rec["sdpa_backend"] = backend.name
        print(json.dumps(rec), flush=True)
        del q, k, v, dout, o, lse, opnds, qt, kt, vt, ot
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--plan", action="store_true")
    ap.add_argument("--fwd", action="store_true")
    ap.add_argument("--bwd", action="store_true")
    ap.add_argument("--check", action="store_true",
                    help="with --bwd: assert two calls give the same bits")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--parent", type=Path, default=None,
                    help="with --bwd: another checkout's root, whose "
                         "mma.sync backward is timed beside this one's")
    ap.add_argument("--rounds", type=int, default=2,
                    help="rounds of (parent, change, change, parent)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_flash needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "torch": torch.__version__}),
          flush=True)
    if args.plan:
        bench_plan(args.iters)
    if args.fwd:
        bench_fwd(args.iters)
    if args.bwd:
        bench_bwd(max(1, args.iters // 4), args.check)
        bench_bwd_mma(max(1, args.iters // 4), args.check, args.parent,
                      args.rounds)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
