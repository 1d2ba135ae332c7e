"""Time the gate kernel (``gating_topk``) on the card, one JSON line a case.

Cases: the rack mode (row 5r) at DeepSeek-V3's prefill shape (T 4096, E
256, top-8, sigmoid, a selection bias) with its node-limited routing (8
racks, 4 kept, group top-2), with 2 racks of which 1, and at decode (T 4);
the free kernel (row 5) at GLM-4.5-Air's prefill and decode (E 128, top-8,
softmax), Jamba-v0.1's (E 16, top-2) and DeepSeek-V3's (E 256, sigmoid,
bias; prefill and decode); and, with ``--geometries``, the rack
geometries of chip_smoke's ``RACK_GATE_CASES`` beyond DeepSeek-V3's, each
beside the PyTorch composite in a graph.  Each time is the device time of
one call from a CUDA graph of many calls: warm (the logits in L2, as the
router's matmul leaves them) and, with ``--cold``, cold (the call rotated
over copies of the logits that together exceed 64 MiB).

``--parent ROOT``: also builds ROOT's ``gating_topk.cu`` (another
checkout) and times both libraries through the same C entry point on the
same inputs, in turns (parent, change, change, parent, then reversed),
with the median over adjacent (parent, change) pairs of change / parent;
``--check`` asserts that both give the same bits wherever both take the
geometry, and that the ids equal the plain rack selection on the kernel's
own keys.  ``--split [parent] [change]``: that library's rack mode taken
apart in one process: the whole kernel, the same kernel in free mode, the
kernel with its cross-block histogram tail cut out, the kernel made empty
(it returns before its first instruction, on the same grid: the launch
and graph-node floor) and, where the source has it, the rack mode with its
rack stage cut out (the lane layout kept), in turns.  The variants are the
source with one line changed (``SPLITS``), built beside it.

Needs the card; the package comes from ``sys.path``:

  PYTHONPATH=src python src/repro_torch/launch/bench_gate.py \\
      --parent build/parent --check --split parent change --cold \\
      --geometries
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels.build import KernelLibrary, build_dir
from repro_torch.kernels.gating_topk import ops
from repro_torch.roofline.hw import H100

HBM_BYTES_PER_S = H100.hbm_bw
# (tag, T, E, k, score_fn, bias, num_racks G, rack_limit M, group top-k,
# graph iterations).
RACK = [("ds_g8_m4", 4096, 256, 8, "sigmoid", True, 8, 4, 2, 20),
        ("ds_g2_m1", 4096, 256, 8, "sigmoid", True, 2, 1, 2, 20),
        ("ds_g8_m4_decode", 4, 256, 8, "sigmoid", True, 8, 4, 2, 50)]
FREE = [("glm_prefill", 4096, 128, 8, "softmax", False, 1, 0, 2, 20),
        ("glm_decode", 4, 128, 8, "softmax", False, 1, 0, 2, 50),
        ("jamba_prefill", 4096, 16, 2, "softmax", False, 1, 0, 2, 20),
        ("ds_e256", 4096, 256, 8, "sigmoid", True, 1, 0, 2, 20),
        ("ds_e256_decode", 4, 256, 8, "sigmoid", True, 1, 0, 2, 50)]
# Rack geometries the kernel's first rack mode refused: Jamba-v0.1's 16
# experts over 8 racks, DBRX's routing (16 experts, top-4) at 8 racks,
# DeepSeek-V2's device-limited routing (160 experts, top-6, 8 devices, 3
# kept, group top-1), E not a multiple of 4, a group top-8, one expert a
# rack.
GEOMETRIES = [("jamba_g8_m2", 4096, 16, 2, "softmax", False, 8, 2, 2, 20),
              ("dbrx_g8_m2", 4096, 16, 4, "softmax", False, 8, 2, 2, 20),
              ("dsv2_g8_m3", 4096, 160, 6, "softmax", False, 8, 3, 1, 20),
              ("e60_g6_m2", 4096, 60, 4, "softmax", False, 6, 2, 2, 20),
              ("ds_g2_m1_gk8", 4096, 256, 8, "sigmoid", True, 2, 1, 8, 20),
              ("e16_g16_m8", 4096, 16, 2, "softmax", False, 16, 8, 1, 20)]
# --split: each variant is the source with the first match of one of its
# patterns replaced (``\g<0>``: the match itself); a variant none of whose
# patterns matches is not built.
_CUT_TAIL = "  if (T >= 0) { if (pending) store_row(); return; }\n\\g<0>"
SPLITS = {
    "empty": [(r"gating_topk_kernel\([^{]*\{\n",
               "\\g<0>  if (T >= 0) return;\n")],
    "no_tail": [(r"  const int Ep = \(E \+ 3\) & ~3;", _CUT_TAIL),
                (r"  int\* acc = scratch \+ SCRATCH_HEAD;", _CUT_TAIL)],
    "no_rack_stage": [(r"if constexpr \(MODE == 1\) \{",
                       "if constexpr (MODE == 1 && false) {")],
    "no_sort": [(r"bitonic<PER, 2, 1>\(p\);", ""),
                (r"sort_desc<PER>\(p\);", "")],
    "no_rounds": [(r"for \(int round = 0; round < k; \+\+round\)",
                   "for (int round = 0; round < 0; ++round)"),
                  (r"    select_rounds<0, G, PER>\(gmask, p, r, k, my_id\);",
                   "")],
}


class Entries:
    """One library's C entry point with its own scratch (ticket zero)."""

    def __init__(self, lib: ctypes.CDLL):
        lib.gating_topk_plan.restype = None
        lib.gating_topk_plan.argtypes = [ctypes.c_int] * 3 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.gating_topk_launch.restype = ctypes.c_int
        lib.gating_topk_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
            + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        self.lib = lib
        out = (ctypes.c_int * 5)()
        lib.gating_topk_plan(0, 1, 1, out)
        self.scratch = torch.zeros(out[4], dtype=torch.int32, device="cuda")

    def takes(self, E, k, G, M, gk) -> bool:
        """Whether the library's entry point takes the rack geometry (the
        first rack mode's entry says so through its chunks a rack)."""
        if hasattr(self.lib, "gating_topk_rack_mode"):
            f = self.lib.gating_topk_rack_mode
            f.restype = ctypes.c_int
            f.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
            return f(E, k, G, M, gk, ctypes.byref(ctypes.c_int(0))) >= 0
        f = self.lib.gating_topk_rack_chunks
        f.restype = ctypes.c_int
        f.argtypes = [ctypes.c_int] * 5
        return f(E, k, G, M, gk) >= 0

    def call(self, x, k, score_fn, bias, racks, out):
        ids, w, cnt, sc = out
        T, E = x.shape
        err = self.lib.gating_topk_launch(
            {"softmax": 0, "sigmoid": 1}[score_fn], x.data_ptr(),
            None if bias is None else bias.data_ptr(), ids.data_ptr(),
            w.data_ptr(), cnt.data_ptr(), sc.data_ptr(),
            self.scratch.data_ptr(), T, E, k, x.stride(0), *racks,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"gating_topk launch failed: CUDA error {err}")


_STREAM = None


def graph_ms(fn, iters: int) -> float:
    """Device time of one call, from one replay of a CUDA graph of
    ``iters`` calls (captured on a side stream, replayed once first)."""
    global _STREAM
    if _STREAM is None:
        _STREAM = torch.cuda.Stream()
    s = _STREAM
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn(0)
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=s):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _outputs(T, E, k):
    return (torch.empty((T, k), dtype=torch.int64, device="cuda"),
            torch.empty((T, k), device="cuda"),
            torch.empty((E,), dtype=torch.int64, device="cuda"),
            torch.empty((T, E), device="cuda"))


def _inputs(tag, T, E, use_bias):
    g = torch.Generator(device="cuda").manual_seed(len(tag) + E)
    x = torch.randn((T, E), generator=g, device="cuda")
    bias = (torch.randn((E,), generator=g, device="cuda") * 1e-2
            if use_bias else None)
    return x, bias


def _bound_ms(T, E, k) -> float:
    """Bytes: logits read once, scores, ids, weights and counts written
    once, at the data sheet's 3.35 TB/s."""
    return (T * E * 8 + T * k * 12 + E * 8) / HBM_BYTES_PER_S * 1e3


def turns(calls: dict, iters: int, rounds: int, cold_x=None):
    """Each call's graph times in turns (every other round reversed) after
    one untimed graph of each; the median over adjacent pairs of each call
    against the first.  ``cold_x``: the calls take a logits tensor, rotated
    over copies of ``cold_x`` that together exceed 64 MiB."""
    names = list(calls)
    if cold_x is not None:
        copies = -(-(64 << 20) // (cold_x.numel() * 4))
        xs = cold_x.expand(copies, *cold_x.shape).clone()
        iters = max(iters, copies)
        fns = {n: (lambda f: lambda i: f(xs[i % copies]))(calls[n])
               for n in names}
    else:
        fns = {n: (lambda f: lambda i: f())(calls[n]) for n in names}
    for n in names:
        graph_ms(fns[n], iters)
    times = {n: [] for n in names}
    seq = []
    for r in range(rounds):
        order = names + names[::-1] if r % 2 == 0 else names[::-1] + names
        for n in order:
            t = graph_ms(fns[n], iters)
            times[n].append(t)
            seq.append((n, t))
    ratios = {}
    if len(names) > 1:
        base = names[0]
        for n in names[1:]:
            pair = [t for m, t in seq if m in (base, n)]
            who = [m for m, t in seq if m in (base, n)]
            ratios[n] = statistics.median(
                (pair[i] / pair[i + 1]) if who[i] == n else
                (pair[i + 1] / pair[i]) for i in range(0, len(pair) - 1, 2))
    return ({n: statistics.median(v) for n, v in times.items()}, times,
            ratios)


def _composite(x, k, score_fn, bias, G, M, gk):
    """The PyTorch composite of the same function (group top-gk -> top-M ->
    mask -> topk -> gather -> scatter-add), graph-capturable."""
    T, E = x.shape
    epg = E // G
    ones = torch.ones((T * k,), dtype=torch.int64, device="cuda")

    def run():
        s = torch.sigmoid(x) if score_fn == "sigmoid" else torch.softmax(x, -1)
        key = s if bias is None else s + bias
        if G > 1:
            grp = torch.topk(key.reshape(T, G, epg), min(gk, epg)).values.sum(-1)
            keep = torch.zeros((T, G), dtype=torch.bool, device="cuda")
            keep.scatter_(1, torch.topk(grp, M).indices, True)
            key = key.masked_fill(~keep.repeat_interleave(epg, dim=1),
                                  float("-inf"))
        i = torch.topk(key, k).indices
        return (s.gather(1, i),
                torch.zeros((E,), dtype=torch.int64, device="cuda"
                            ).scatter_add_(0, i.reshape(-1), ones))
    return run


def _check(tag, libs, x, k, score_fn, bias, racks):
    """Every library's outputs: the same bits, the ids the plain selection
    on the kernel's own keys, the counts their histogram."""
    T, E = x.shape
    outs = {}
    for who, e in libs.items():
        outs[who] = _outputs(T, E, k)
        e.call(x, k, score_fn, bias, racks, outs[who])
    torch.cuda.synchronize()
    first = next(iter(outs.values()))
    for who, o in outs.items():
        for a, b in zip(first, o):
            if not torch.equal(a, b):
                raise AssertionError(f"{tag}: {who} differs")
    ids, _, cnt, sc = first
    keys = sc if bias is None else sc + bias[None, :]
    want = (ops.rack_limited_ids(keys, k, *racks) if racks[0] > 1
            else ops._top(keys, k))
    if not torch.equal(ids, want):
        raise AssertionError(f"{tag}: ids differ from the plain selection")
    if not torch.equal(cnt, torch.bincount(ids.reshape(-1), minlength=E)):
        raise AssertionError(f"{tag}: counts are not the histogram")


def _variant(root: Path, who: str, name: str) -> KernelLibrary | None:
    kdir = root / "src" / "repro_torch" / "kernels"
    src = (kdir / "gating_topk" / "csrc" / "gating_topk.cu").read_text()
    for pattern, repl in SPLITS[name]:
        if re.search(pattern, src):
            out = build_dir() / f"gate_split_{who}_{name}"
            out.mkdir(parents=True, exist_ok=True)
            (out / "gating_topk.cu").write_text(
                re.sub(pattern, repl, src, count=1))
            return KernelLibrary(f"gating_topk_{who}_{name}",
                                 out / "gating_topk.cu",
                                 include=kdir / "csrc")
    return None


def _emit(rec):
    print(json.dumps(rec), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--split", nargs="*", default=None,
                    choices=("parent", "change"),
                    help="whose rack mode to take apart (default: parent)")
    ap.add_argument("--cold", action="store_true")
    ap.add_argument("--geometries", action="store_true")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_gate: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    builds = {}
    if args.parent is not None:
        kdir = args.parent / "src" / "repro_torch" / "kernels"
        builds["parent"] = KernelLibrary(
            "gating_topk_parent", kdir / "gating_topk" / "csrc"
            / "gating_topk.cu", include=kdir / "csrc")
    builds["change"] = ops.LIBRARY
    roots = {"parent": args.parent,
             "change": Path(ops.__file__).resolve().parents[4]}
    splits = {}                                  # who -> {variant: library}
    for who in ((args.split or ["parent"]) if args.split is not None else []):
        if roots[who] is None:
            continue
        splits[who] = {}
        for name in SPLITS:
            lib = _variant(roots[who], who, name)
            if lib is not None:
                splits[who][name] = lib
    every = list(builds.values()) + [
        lib for v in splits.values() for lib in v.values()]
    procs = [lib.start_build() for lib in every]
    for lib, proc in zip(every, procs):
        lib.finish_build(proc)
    libs = {who: Entries(lib.load()) for who, lib in builds.items()}
    split_libs = {who: {name: Entries(lib.load()) for name, lib in v.items()}
                  for who, v in splits.items()}
    _emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "torch": torch.__version__, "libraries": list(libs),
           "splits": {w: list(v) for w, v in split_libs.items()},
           "ptxas": [ln.strip() for ln in ops.LIBRARY.ptxas_log.splitlines()
                     if "registers" in ln or "spill" in ln
                     or "smem" in ln]})

    cases = RACK + FREE + (GEOMETRIES if args.geometries else [])
    for tag, T, E, k, score_fn, use_bias, G, M, gk, iters in cases:
        x, bias = _inputs(tag, T, E, use_bias)
        racks = (G, M, gk)
        takes = {w: e for w, e in libs.items() if e.takes(E, k, *racks)}
        if args.check:
            _check(tag, takes, x, k, score_fn, bias, racks)
        outs = {w: _outputs(T, E, k) for w in takes}

        def bind(e, o):
            return lambda xi=x: e.call(xi, k, score_fn, bias, racks, o)
        calls = {w: bind(e, outs[w]) for w, e in takes.items()}
        rec = {"case": tag, "shape": [T, E, k], "score_fn": score_fn,
               "bias": use_bias, "racks": list(racks),
               "bound_ms": _bound_ms(T, E, k), "bound_by": "bytes",
               "nvidia_smi": smi}
        med, times, ratios = turns(calls, iters, args.rounds)
        rec.update({"warm_ms": med, "warm_all": times,
                    "warm_ratio_change_over_parent": ratios.get("change")})
        if args.cold and T >= 1024:
            med, times, ratios = turns(calls, iters, args.rounds, cold_x=x)
            rec.update({"cold_ms": med, "cold_all": times,
                        "cold_ratio_change_over_parent":
                            ratios.get("change")})
        if G > 1 and "parent" not in takes:
            run = _composite(x, k, score_fn, bias, G, M, gk)
            rec["torch_ops_graph_ms"] = graph_ms(lambda i: run(), iters)
        for who, variants in split_libs.items():
            if G <= 1 or who not in takes:
                continue
            lib = libs[who]
            sc = {"whole": calls[who],
                  "free_mode": (lambda o: lambda xi=x: lib.call(
                      xi, k, score_fn, bias, (1, 0, 2), o))(_outputs(T, E, k))}
            for name, e in variants.items():
                sc[name] = bind(e, _outputs(T, E, k))
            med, times, ratios = turns(sc, iters, args.rounds)
            rec[f"split_{who}_warm_ms"] = med
            rec[f"split_{who}_ratio_over_whole"] = ratios
            if args.cold and T >= 1024:
                med, _, _ = turns({"whole": sc["whole"]}, iters, args.rounds,
                                  cold_x=x)
                rec[f"split_{who}_cold_whole_ms"] = med["whole"]
        _emit(rec)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
