"""Time the grouped GEMM kernels on the card, one JSON line a case.

Cases: rows 1-2 in bf16 (the forward SwiGLU and matmul) at GLM-4.5-Air's
serve counts (4096 tokens, capacity factors 4.0) and dense (G 130, M
1009); the backward B1 (the SwiGLU backward), B2 (dact = dy w2^T, dx = dh
w1^T + dg w3^T) and B3 (wgrad, dw1 = x^T dh) at three shapes:
GLM-4.5-Air's train counts (8192 tokens, capacity factors 4.0: G 130, cap
2017, K 4096, N 1408; B3's dw2 = act^T dy too), DeepSeek-V3's train cell
(4096 tokens, capacity factors 2.0, K 7168, N 2048) and Jamba-v0.1's
(4096 tokens, 2.0, K 4096, N 14336).  Each slot's row count comes from
the port's gate, ``ultraep`` plan and bucket on seeded tokens; padded
rows of the inputs hold NaN, which no kernel may let into a valid output.
Each line: the kernel's time (CUDA events over repeated launches), its
bound on the valid work (bytes or bf16 operations at the data sheet's
rates, whichever is larger) and ``torch.bmm`` over the padded buffers.
B1 and B2 are timed twice: the public call (rows past the count written
as zeros) and the train step's call (``_train_call``: rows from the count
rounded up to 64 on unwritten), the parent's one call beside each where
it has no such mode.

``--parent ROOT``: also builds ROOT's ``grouped_gemm.cu`` (another
checkout, with its own shared headers) and times both libraries through
the same C entry points on the same inputs, in turns (parent, change,
change, parent); ``--check`` asserts that the two give the same bits
(each output element sums the same products in the same order) and that
B1's rows past the count are zeros.  ``--split``: B1, B2 (both modes) and
B3 at GLM's widths with every slot holding the same row count (0, 64,
..., 1024), and a least-squares fit t = fixed + per_tile x tiles over
those runs (B3: 64-row token tiles a block contracts; B1 and B2: 128-row
tiles): ``fixed`` is what the launch pays whatever the rows (prologues,
epilogues, stores of zero tiles), ``per_tile`` the main loop.

``--f32 SHAPES``: B1f, B2f (dx) and B3f, the fp32 backward of
``csrc/grouped_gemm_bwd_f32.cu``, at GLM-4.5-Air's full width and train
counts (``glm_train``) and at the reduced GLM-4.5-Air's path (``glm_reduced``:
``train()``'s defaults, 8 x 128 tokens), B1f and B2f as the public call
and the train step's call, each beside fp32 ``torch.bmm`` over the padded
buffers (TF32 off), and where a call takes under a millisecond each
one's device time alone from CUDA-graph replays (``graph_ms``,
``bmm_graph_ms``); with ``--parent`` ROOT's ``grouped_gemm_bwd_f32.cu``
is built and timed in turns on the same inputs, and ``--check`` asserts
that each library gives the same bits on two calls, is within 1e-4 of
each output's max|ref| against the plain version (the two sum in other
orders, so they are not compared bit for bit), never lets the NaN of the
padded rows into a valid one, and that the public call's padded rows are
zeros.

Needs the card; the package comes from ``sys.path``:

  PYTHONPATH=src python src/repro_torch/launch/bench_grouped.py \\
      --parent build/parent --check --split
  PYTHONPATH=src python src/repro_torch/launch/bench_grouped.py \\
      --parent build/parent --check --no-forward --shapes "" \\
      --f32 glm_reduced,glm_train
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels.build import KernelLibrary
from repro_torch.kernels.grouped_gemm import ops
from repro_torch.roofline.hw import H100

HBM_BYTES_PER_S = H100.hbm_bw
BF16_OPS_PER_S = H100.peak("bf16")
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


class Entries:
    """The C entry points of one build of ``grouped_gemm.cu``, called on
    preallocated outputs (the wrappers' allocations are not timed)."""

    def __init__(self, lib: ctypes.CDLL):
        self.fwd = lib.grouped_gemm_launch
        self.fwd.argtypes = [_I, _I] + [_P] * 5 + [_I] * 5 + [_L] * 4 + [_P]
        # B2's own entry (a work counter zeroed before each launch), or the
        # parent's modes 3 and 4 of the backward entry.
        self.nt = getattr(lib, "grouped_matmul_nt_launch", None)
        if self.nt is not None:
            self.nt.argtypes = [_I, _I] + [_P] * 7 + [_I] * 4 + [_L] * 4 + [_P]
        self.bwd = getattr(lib, "grouped_gemm_bwd_launch", None)
        if self.bwd is not None:
            self.bwd.argtypes = [_I] + [_P] * 8 + [_I] * 5 + [_L] * 4 + [_P]
        self.wg = lib.grouped_wgrad_launch
        self.wg.argtypes = [_P] * 4 + [_I] * 4 + [_L] * 4 + [_P]
        # B1's own entry (a work counter zeroed before each launch), or the
        # parent's mode 2 of the backward entry.
        self.b1 = getattr(lib, "grouped_swiglu_bwd_launch", None)
        if self.b1 is not None:
            self.b1.argtypes = [_I] + [_P] * 8 + [_I] * 4 + [_L] * 4 + [_P]
        for fn in (self.fwd, self.nt, self.bwd, self.wg, self.b1):
            if fn is not None:
                fn.restype = _I

    @staticmethod
    def _ok(err: int, what: str) -> None:
        if err:
            raise RuntimeError(f"{what}: launch error {err}")

    @staticmethod
    def _stream() -> int:
        return torch.cuda.current_stream().cuda_stream

    def forward(self, x, w1, w3, rows, out, swiglu: bool):
        G, M, K = x.shape
        N = w1.shape[2]
        self._ok(self.fwd(1, int(swiglu), x.data_ptr(), w1.data_ptr(),
                          (w3 if swiglu else w1).data_ptr(), out.data_ptr(),
                          rows.data_ptr(), G, M, K, N, out.shape[2],
                          x.stride(0), x.stride(1), w1.stride(0),
                          w1.stride(1), self._stream()), "forward")

    def swiglu_bwd(self, x, w1, w3, dact, rows, dh, dg, zero_pad=True):
        G, M, K = x.shape
        N = w1.shape[2]
        if self.b1 is None:
            self._ok(self.bwd(2, x.data_ptr(), x.data_ptr(), w1.data_ptr(),
                              w3.data_ptr(), dh.data_ptr(), dg.data_ptr(),
                              dact.data_ptr(), rows.data_ptr(), G, M, K, N, N,
                              x.stride(0), x.stride(1), w1.stride(0),
                              w1.stride(1), self._stream()), "swiglu_bwd")
            return
        nxt = torch.zeros(1, dtype=torch.int32, device=x.device)
        self._ok(self.b1(int(zero_pad), x.data_ptr(), w1.data_ptr(),
                         w3.data_ptr(), dh.data_ptr(), dg.data_ptr(),
                         dact.data_ptr(), rows.data_ptr(), nxt.data_ptr(), G,
                         M, K, N, x.stride(0), x.stride(1), w1.stride(0),
                         w1.stride(1), self._stream()), "swiglu_bwd")

    def matmul_nt(self, x, w, rows, out, x2=None, w2=None, zero_pad=True):
        G, M, K = x.shape
        N = w.shape[1]
        x2, w2 = (x, w) if x2 is None else (x2, w2)
        if self.nt is None:
            self._ok(self.bwd(3 if x2 is x else 4, x.data_ptr(),
                              x2.data_ptr(), w.data_ptr(), w2.data_ptr(),
                              out.data_ptr(), None, None, rows.data_ptr(), G,
                              M, K, N, N, x.stride(0), x.stride(1),
                              w.stride(0), w.stride(1), self._stream()),
                     "matmul_nt")
            return
        nxt = torch.zeros(1, dtype=torch.int32, device=x.device)
        self._ok(self.nt(int(zero_pad), int(x2 is not x), x.data_ptr(),
                         x2.data_ptr(), w.data_ptr(), w2.data_ptr(),
                         out.data_ptr(), rows.data_ptr(), nxt.data_ptr(), G,
                         M, K, N, x.stride(0), x.stride(1), w.stride(0),
                         w.stride(1), self._stream()), "matmul_nt")

    def wgrad(self, x, d, rows, out):
        G, M, K = x.shape
        self._ok(self.wg(x.data_ptr(), d.data_ptr(), out.data_ptr(),
                         rows.data_ptr(), G, M, K, d.shape[2], x.stride(0),
                         x.stride(1), d.stride(0), d.stride(1),
                         self._stream()), "wgrad")


class F32Entries:
    """The C entry point of one build of ``grouped_gemm_bwd_f32.cu``: this
    checkout's (a workspace, ``zero_padded`` and the wgrad's chunk) or an
    older one without them (``legacy``: zeros always written, no
    chunks)."""

    def __init__(self, lib: ctypes.CDLL, legacy: bool):
        self.fn = lib.grouped_bwd_f32_launch
        self.legacy = legacy
        self.ws = {}                    # the wgrad's workspace by shape
        self.fn.restype = _I
        self.fn.argtypes = ([_I] + [_P] * (8 if legacy else 9) + [_I] * 4
                            + [_L] * 4 + ([] if legacy else [_I] * 2) + [_P])

    def __call__(self, mode, a, a2, b, b2, dact, out, out2, rows, *,
                 zero_pad=True):
        G, M, K = a.shape
        N = out.shape[2]
        ptrs = [None if t is None else t.data_ptr()
                for t in (a, a2, b, b2, dact, out, out2)]
        strides = (a.stride(0), a.stride(1), b.stride(0), b.stride(1))
        stream = torch.cuda.current_stream().cuda_stream
        if self.legacy:
            err = self.fn(mode, *ptrs, rows.data_ptr(), G, M, K, N, *strides,
                          stream)
        else:
            sms = ops._sm_count(a.get_device())
            chunk = ops.wgrad_f32_chunk(G, M, K, N, sms) if mode == 2 else 0
            # Made once a shape, as the outputs are: the timed calls
            # allocate nothing.
            key = (G, M, K, N, chunk)
            if chunk and key not in self.ws:
                self.ws[key] = torch.empty(G * (1 + -(-M // chunk)) * K * N,
                                           device=a.device)
            ws = self.ws.get(key)
            # The partial sums go after G output slots, as the wrapper's.
            wsp = None if ws is None else ws.data_ptr() + G * K * N * 4
            err = self.fn(mode, *ptrs, wsp, rows.data_ptr(), G, M, K, N,
                          *strides, int(zero_pad), chunk, stream)
        if err:
            raise RuntimeError(f"grouped_bwd_f32 mode {mode}: launch error "
                               f"{err}")


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


def _graph_ms(fn, iters: int, reps: int = 5) -> float | None:
    """Device time of one call of ``fn`` from replays of a CUDA graph of
    ``iters`` calls (no host work in the time), or None where the capture
    fails."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(g, capture_error_mode="relaxed"):
            for _ in range(iters):
                fn()
    except RuntimeError:
        return None
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def _bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_mem = flops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, "operations" if t_ops >= t_mem else "bytes"


def slot_rows(arch: str, tokens: int, cf: float, seed: int,
              reduce: bool = False):
    """(rows, cap, d_model, d_ff): each slot's valid-row count and the slot
    capacity from the port's gate, ``ultraep`` plan and bucket on
    ``tokens`` seeded tokens at capacity factors ``cf`` (one EP rank;
    ``reduce``: the arch's reduced configuration)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.reduce import reduced
    from repro_torch.core.balancer import BalancerConfig
    from repro_torch.models.transformer import (
        ParallelCtx,
        RuntimeConfig,
        moe_config,
    )
    from repro_torch.moe import stages

    cfg = get_config(arch)
    cfg = reduced(cfg) if reduce else cfg
    rcfg = RuntimeConfig(balancer=BalancerConfig(mode="ultraep"), cf_pair=cf,
                         cf_slot=cf, dtype=torch.bfloat16)
    mcfg = moe_config(cfg, rcfg, ParallelCtx(), tokens)
    g = torch.Generator(device="cuda").manual_seed(seed)
    D = cfg.d_model
    router = torch.randn((D, cfg.moe.num_experts), generator=g,
                         device="cuda") * D ** -0.5
    x = torch.randn((tokens, D), generator=g, device="cuda").to(torch.bfloat16)
    ctx = stages.make_stage_ctx(mcfg, None)
    gs = stages.gate_stage(ctx, x, router)
    ps = stages.plan_stage(ctx, gs)
    ds = stages.dispatch_stage(ctx, x, gs.gate_out.expert_ids, gs, ps)
    return ds.rows, mcfg.cap_slot, D, cfg.moe.d_ff


# name -> (arch, tokens, capacity factors, seed): GLM's train counts are
# chip_smoke phase 12's, its serve counts phase 2's.
SHAPES = {"glm_train": ("glm45-106b-a12b", 8192, 4.0, 7),
          "deepseek_cell": ("deepseek-v3-671b", 4096, 2.0, 7),
          "jamba_cell": ("jamba-v0.1-52b", 4096, 2.0, 7),
          "glm_serve": ("glm45-106b-a12b", 4096, 4.0, 13)}


# name -> (arch, tokens, capacity factors, seed, reduced): the fp32
# backward's cases, chip_smoke phase 19's grouped_bwd_f32_glm and
# grouped_bwd_f32 counts.
F32_SHAPES = {"glm_train": ("glm45-106b-a12b", 8192, 4.0, 7, False),
              "glm_reduced": ("glm45-106b-a12b", 8 * 128, 4.0, 7, True)}


def _randn(shape, scale, g):
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(
        torch.bfloat16)


def _padded(t, rows, fill=float("nan")):
    """``t`` (G, M, ...) with the rows at or past ``rows[g]`` set to
    ``fill``."""
    pad = torch.arange(t.shape[1], device=t.device)[None, :] >= rows[:, None]
    return torch.where(pad[..., None], fill, t.float()).to(t.dtype)


class Bench:
    def __init__(self, libs: dict[str, Entries], iters: int, check: bool,
                 rounds: int):
        self.libs, self.iters, self.check = libs, iters, check
        self.rounds = rounds

    def turns(self, make_call) -> tuple[dict, float | None]:
        """Each library's times in turns, ``rounds`` of (parent, change,
        change, parent) with every other round reversed, after
        ``3 * iters`` untimed launches of each (the card's clocks settle
        under a long product); ``make_call(who, entries)`` gives a
        no-argument launch.  Also the median over the adjacent (parent,
        change) turns of change / parent: the card's clocks drift over a
        case, and a pair of neighbouring turns sees the same clocks."""
        one = ["parent", "change"] if "parent" in self.libs else ["change"]
        order = []
        for r in range(self.rounds):
            order += (one + one[::-1]) if r % 2 == 0 else (one[::-1] + one)
        times = {k: [] for k in self.libs}
        calls = {k: make_call(k, e) for k, e in self.libs.items()}
        for call in calls.values():
            _event_ms(call, 3 * self.iters)
        seq = []
        for k in order:
            seq.append((k, _event_ms(calls[k], self.iters)))
            times[k].append(seq[-1][1])
        ratio = None
        if len(one) == 2:
            ratio = statistics.median(
                dict(seq[i:i + 2])["change"] / dict(seq[i:i + 2])["parent"]
                for i in range(0, len(seq), 2))
        return times, ratio

    def same_bits(self, name, outs: dict, whole: bool = True,
                  rows=None) -> bool | None:
        """Parent and change equal bit for bit (``whole`` False: on the
        valid rows of each slot only)."""
        if not self.check or "parent" not in outs:
            return None
        torch.cuda.synchronize()
        for a, b in zip(outs["parent"], outs["change"]):
            if not whole:
                keep = torch.arange(a.shape[1], device=a.device)[
                    None, :, None] < rows[:, None, None]
                a, b = torch.where(keep, a, 0), torch.where(keep, b, 0)
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: parent and change differ")
        return True


def _emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def _case(name, shape, rows, bench, fn, outs, flops, nbytes, bmm=None,
          **extra):
    """Time ``fn(entries, outs[who])`` for each library, check bits, emit."""
    times, ratio = bench.turns(lambda who, e: lambda: fn(e, outs[who]))
    same = bench.same_bits(name, outs, extra.get("zero_padded", True), rows)
    bound, by = _bound_ms(flops, nbytes)
    rec = {"case": name, "shape": shape, "rows": int(rows.sum()),
           "slots_with_rows": int((rows > 0).sum()), "ms": times,
           "median_ms": {k: statistics.median(v) for k, v in times.items()},
           "pair_ratio_median": ratio,
           "bound_ms": bound, "bound_by": by, "same_bits": same, **extra}
    if bmm is not None:
        rec["bmm_ms"] = _event_ms(bmm, bench.iters)
    _emit(rec)
    return rec


def bench_forward(bench: Bench) -> None:
    rows_s, cap, K, N = slot_rows(*SHAPES["glm_serve"])
    g = torch.Generator(device="cuda").manual_seed(11)
    for tag, G, M, rows in (("serve", rows_s.numel(), cap, rows_s),
                            ("dense", 130, 1009, None)):
        rows = (torch.full((G,), M, device="cuda", dtype=torch.int64)
                if rows is None else rows)
        x = _padded(_randn((G, M, K), 1.0, g), rows, 0.0)
        w1, w3 = _randn((G, K, N), K ** -0.5, g), _randn((G, K, N),
                                                         K ** -0.5, g)
        w2 = _randn((G, N, K), N ** -0.5, g)
        a = _padded(_randn((G, M, N), 1.0, g), rows, 0.0)
        R, S = int(rows.sum()), int((rows > 0).sum())
        shape = dict(G=G, M=M, K=K, N=N)
        outs = {k: (torch.empty((G, M, N), dtype=x.dtype, device="cuda"),)
                for k in bench.libs}
        _case(f"row1_swiglu_{tag}", shape, rows, bench,
              lambda e, o: e.forward(x, w1, w3, rows, o[0], True), outs,
              4.0 * R * K * N, 2 * (R * K + 2 * S * K * N + R * N),
              bmm=lambda: (torch.bmm(x, w1), torch.bmm(x, w3)))
        outs = {k: (torch.empty((G, M, K), dtype=x.dtype, device="cuda"),)
                for k in bench.libs}
        _case(f"row2_matmul_{tag}", dict(G=G, M=M, K=N, N=K), rows, bench,
              lambda e, o: e.forward(a, w2, None, rows, o[0], False), outs,
              2.0 * R * K * N, 2 * (R * N + S * K * N + R * K),
              bmm=lambda: torch.bmm(a, w2))
        del x, w1, w3, w2, a, outs
        torch.cuda.empty_cache()


def bench_backward(bench: Bench, shape_name: str, dw2: bool) -> None:
    rows, cap, K, N = slot_rows(*SHAPES[shape_name])
    G, M = rows.numel(), cap
    R, S = int(rows.sum()), int((rows > 0).sum())
    g = torch.Generator(device="cuda").manual_seed(12)
    x = _padded(_randn((G, M, K), 1.0, g), rows)
    w1, w3 = _randn((G, K, N), K ** -0.5, g), _randn((G, K, N), K ** -0.5, g)
    dact = _padded(_randn((G, M, N), 1.0, g), rows)
    shape = dict(G=G, M=M, K=K, N=N)
    tiles = ops.swiglu_bwd_tiles(rows, M, N).shape[0]
    # B1: the public call (padded rows written as zeros) against the
    # parent's, then the train step's call (rows from the count rounded up
    # to 64 on unwritten) against the parent's, each in turns.
    outs = {k: (torch.empty((G, M, N), dtype=x.dtype, device="cuda"),
                torch.empty((G, M, N), dtype=x.dtype, device="cuda"))
            for k in bench.libs}
    for tag, zero in (("", True), ("_train_call", False)):
        _case(f"b1_swiglu_bwd_{shape_name}{tag}", shape, rows, bench,
              lambda e, o: e.swiglu_bwd(x, w1, w3, dact, rows, *o,
                                        zero_pad=zero or e.b1 is None),
              outs, 4.0 * R * K * N, 2 * (R * K + 2 * S * K * N + 3 * R * N),
              bmm=(lambda: (torch.bmm(x, w1), torch.bmm(x, w3))) if zero
              else None, work_items=tiles, zero_padded=zero)
        if zero:
            dh, dg = (t.clone() for t in outs["change"])
    if bench.check:
        keep = torch.arange(M, device="cuda")[None, :, None] < rows[:, None,
                                                                    None]
        for t in (dh, dg):
            if not torch.all(torch.where(keep, 0.0, t.float()) == 0):
                raise AssertionError("b1: a padded row is not zero")
    del outs
    # B3: dw1 = x^T dh.
    outs = {k: (torch.empty((G, K, N), dtype=x.dtype, device="cuda"),)
            for k in bench.libs}
    dhn = _padded(dh, rows)
    _case(f"b3_wgrad_{shape_name}", dict(G=G, M=M, K=K, N=N), rows, bench,
          lambda e, o: e.wgrad(x, dhn, rows, o[0]), outs, 2.0 * R * K * N,
          2 * (R * K + R * N + G * K * N),
          bmm=lambda: torch.bmm(x.transpose(1, 2), dhn),
          tiles=ops.wgrad_tiles(G, K, N).shape[0])
    del outs
    w2 = _randn((G, N, K), N ** -0.5, g)
    dy = _padded(_randn((G, M, K), 1.0, g), rows)
    if dw2:
        # B3's dw2 = act^T dy.
        act = _padded(_randn((G, M, N), 1.0, g), rows)
        outs = {k: (torch.empty((G, N, K), dtype=x.dtype, device="cuda"),)
                for k in bench.libs}
        _case(f"b3_wgrad_dw2_{shape_name}", dict(G=G, M=M, K=N, N=K), rows,
              bench, lambda e, o: e.wgrad(act, dy, rows, o[0]), outs,
              2.0 * R * K * N, 2 * (R * K + R * N + G * K * N),
              bmm=lambda: torch.bmm(act.transpose(1, 2), dy))
        del act
    # B2's dact = dy w2^T and dx = dh w1^T + dg w3^T: the public call, then
    # the train step's.
    dgn = _padded(dg, rows)
    b2_tiles = {n: ops.matmul_nt_tiles(rows, M, n).shape[0] for n in (N, K)}
    for tag, zero in (("", True), ("_train_call", False)):
        outs = {k: (torch.empty((G, M, N), dtype=x.dtype, device="cuda"),)
                for k in bench.libs}
        _case(f"b2_dact_{shape_name}{tag}", dict(G=G, M=M, K=K, N=N), rows,
              bench, lambda e, o: e.matmul_nt(dy, w2, rows, o[0],
                                              zero_pad=zero),
              outs, 2.0 * R * K * N, 2 * (R * K + S * K * N + R * N),
              bmm=(lambda: torch.bmm(dy, w2.transpose(1, 2))) if zero
              else None, work_items=b2_tiles[N], zero_padded=zero)
        outs = {k: (torch.empty((G, M, K), dtype=x.dtype, device="cuda"),)
                for k in bench.libs}
        _case(f"b2_dx_{shape_name}{tag}", dict(G=G, M=M, K=N, N=K), rows,
              bench, lambda e, o: e.matmul_nt(dhn, w1, rows, o[0], dgn, w3,
                                              zero_pad=zero),
              outs, 4.0 * R * K * N, 2 * (2 * R * N + 2 * S * K * N + R * K),
              bmm=(lambda: torch.bmm(dhn, w1.transpose(1, 2))
                   + torch.bmm(dgn, w3.transpose(1, 2))) if zero else None,
              work_items=b2_tiles[K], zero_padded=zero)
        del outs
    torch.cuda.empty_cache()


def bench_backward_f32(libs: dict, shape_name: str, iters: int,
                       check: bool, rounds: int) -> None:
    """B1f, B2f (dx = dh w1^T + dg w3^T) and B3f (dw1 = x^T dh) in fp32,
    NaN in every operand's padded rows, each library in turns beside
    fp32 ``torch.bmm`` over the padded buffers."""
    rows, cap, K, N = slot_rows(*F32_SHAPES[shape_name])
    G, M = rows.numel(), cap
    R, S = int(rows.sum()), int((rows > 0).sum())
    g = torch.Generator(device="cuda").manual_seed(12)
    f32 = torch.float32
    x = _padded(torch.randn((G, M, K), generator=g, device="cuda"), rows)
    w1, w3 = (torch.randn((G, K, N), generator=g, device="cuda") * K ** -0.5
              for _ in range(2))
    dact = _padded(torch.randn((G, M, N), generator=g, device="cuda"), rows)
    keep = torch.arange(M, device="cuda")[None, :, None] < rows[:, None, None]
    x0, dact0 = torch.where(keep, x, 0.0), torch.where(keep, dact, 0.0)
    dh, dg = ops.grouped_swiglu_bwd_ref(x0, w1, w3, dact0, rows)
    dhn, dgn = _padded(dh, rows), _padded(dg, rows)
    shape = dict(G=G, M=M, K=K, N=N)

    def empty(*shape_):
        return {who: torch.empty(shape_, dtype=f32, device="cuda")
                for who in libs}

    cases = []
    for tag, zero in (("", True), ("_train_call", False)):
        o1, o2 = empty(G, M, N), empty(G, M, N)
        cases.append((f"b1f_swiglu_bwd_{shape_name}{tag}", zero,
                      lambda e, who, z=zero, a=o1, b=o2: e(
                          1, x, None, w1, w3, dact, a[who], b[who], rows,
                          zero_pad=z),
                      lambda who, a=o1, b=o2: (a[who], b[who]),
                      lambda: ops.grouped_swiglu_bwd_ref(x0, w1, w3, dact0,
                                                         rows),
                      (lambda: (torch.bmm(x0, w1), torch.bmm(x0, w3)))
                      if zero else None, 4.0 * R * K * N))
    for tag, zero in (("", True), ("_train_call", False)):
        o = empty(G, M, K)
        cases.append((f"b2f_dx_{shape_name}{tag}", zero,
                      lambda e, who, z=zero, a=o: e(
                          0, dhn, dgn, w1, w3, None, a[who], None, rows,
                          zero_pad=z),
                      lambda who, a=o: (a[who],),
                      lambda: (ops.grouped_matmul_nt_ref(dh, w1, rows, dg,
                                                         w3),),
                      (lambda: torch.bmm(dh, w1.transpose(1, 2))
                       + torch.bmm(dg, w3.transpose(1, 2))) if zero else None,
                      4.0 * R * K * N))
    o = empty(G, K, N)
    cases.append((f"b3f_wgrad_{shape_name}", True,
                  lambda e, who, a=o: e(2, x, None, dhn, None, None, a[who],
                                        None, rows),
                  lambda who, a=o: (a[who],),
                  lambda: (ops.grouped_wgrad_ref(x0, dh, rows),),
                  lambda: torch.bmm(x0.transpose(1, 2), dh),
                  2.0 * R * K * N))
    for name, zero, call, outs, ref, bmm, flops in cases:
        rec = {"case": name, "shape": shape, "rows": R, "slots_with_rows": S,
               "dtype": "float32", "zero_padded": zero,
               "libraries": list(libs)}
        if check:
            refs = ref()
            rec["rel_err"] = {}
            for who, e in libs.items():
                call(e, who)
                first = [t.clone() for t in outs(who)]
                call(e, who)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in
                           zip(first, outs(who))):
                    raise AssertionError(f"{name} {who}: two calls differ")
                errs = []
                for a, r in zip(first, refs):
                    if a.shape[1] == M:
                        if zero and not torch.all(
                                torch.where(keep, 0.0, a) == 0):
                            raise AssertionError(f"{name} {who}: a padded "
                                                 f"row is not zero")
                        a = torch.where(keep, a, 0.0)
                    if not torch.isfinite(a).all():
                        raise AssertionError(f"{name} {who}: not finite")
                    errs.append((a - r).abs().max().item()
                                / max(r.abs().max().item(), 1e-30))
                if not max(errs) <= 1e-4:
                    raise AssertionError(f"{name} {who}: {errs} of max|ref|")
                rec["rel_err"][who] = errs
            rec["bitwise_two_calls"] = True
            del refs, first
        one = list(libs)
        order = []
        for r in range(rounds):
            order += (one + one[::-1]) if r % 2 == 0 else (one[::-1] + one)
        for who, e in libs.items():
            _event_ms(lambda: call(e, who), iters)
        times = {who: [] for who in libs}
        for who in order:
            times[who].append(_event_ms(lambda: call(libs[who], who), iters))
        rec["ms"] = times
        rec["median_ms"] = {w: statistics.median(t) for w, t in times.items()}
        if "parent" in libs:
            rec["change_over_parent"] = (rec["median_ms"]["change"]
                                         / rec["median_ms"]["parent"])
        rec["bound_ms_tf32x3"] = 3 * flops / H100.peak("tf32") * 1e3
        if bmm is not None:
            rec["bmm_ms"] = _event_ms(bmm, iters)
        # Device time alone (a graph's replays), where calls are short
        # enough that the host's launch work may set the eager time.
        if rec["median_ms"]["change"] < 1.0:
            rec["graph_ms"] = {who: _graph_ms(lambda: call(e, who), iters)
                               for who, e in libs.items()}
            if bmm is not None:
                rec["bmm_graph_ms"] = _graph_ms(bmm, iters)
        _emit(rec)
    del x, w1, w3, dact, x0, dact0, dh, dg, dhn, dgn
    torch.cuda.empty_cache()


def _fit(xs, ts) -> dict:
    n = len(xs)
    mx, mt = sum(xs) / n, sum(ts) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    b = sum((x - mx) * (t - mt) for x, t in zip(xs, ts)) / sxx
    return {"fixed_ms": mt - b * mx, "per_tile_ms": b}


def bench_split(bench: Bench) -> None:
    """B1, B2 and B3 at GLM's widths and train capacity, every slot at one
    row count; the fit of time against the tiles each kernel contracts."""
    G, M, K, N = 130, 2017, 4096, 1408
    g = torch.Generator(device="cuda").manual_seed(13)
    x = _randn((G, M, K), 1.0, g)
    w1, w3 = _randn((G, K, N), K ** -0.5, g), _randn((G, K, N), K ** -0.5, g)
    w2 = _randn((G, N, K), N ** -0.5, g)
    d = _randn((G, M, N), 1.0, g)
    dh, dg = torch.empty_like(d), torch.empty_like(d)
    out = torch.empty((G, K, N), dtype=x.dtype, device="cuda")
    dx = torch.empty_like(x)
    counts = (0, 64, 128, 256, 512, 1024)
    calls = {
        "b1": lambda e, rows: e.swiglu_bwd(x, w1, w3, d, rows, dh, dg),
        "b3": lambda e, rows: e.wgrad(x, d, rows, out),
        "b2_dact": lambda e, rows: e.matmul_nt(x, w2, rows, dh),
        "b2_dact_train_call": lambda e, rows: e.matmul_nt(
            x, w2, rows, dh, zero_pad=False),
        "b2_dx": lambda e, rows: e.matmul_nt(d, w1, rows, dx, d, w3),
        "b2_dx_train_call": lambda e, rows: e.matmul_nt(
            d, w1, rows, dx, d, w3, zero_pad=False)}
    for who, e in bench.libs.items():
        rec = {"case": f"split_{who}", "shape": dict(G=G, M=M, K=K, N=N),
               "rows_per_slot": counts}
        for name, call in calls.items():
            t = []
            for r in counts:
                rows = torch.full((G,), r, device="cuda", dtype=torch.int64)
                t.append(_event_ms(lambda: call(e, rows), bench.iters))
            tile = 64 if name == "b3" else 128
            rec[f"{name}_ms"] = t
            rec[f"{name}_fit_{tile}_row_tiles"] = _fit(
                [G * math.ceil(r / tile) for r in counts], t)
        _emit(rec)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout's root: time its grouped_gemm.cu "
                         "beside this one")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=2,
                    help="rounds of (parent, change, change, parent)")
    ap.add_argument("--shapes", default="glm_train,deepseek_cell,jamba_cell")
    ap.add_argument("--no-forward", action="store_true")
    ap.add_argument("--f32", default="",
                    help="fp32 backward shapes: glm_reduced, glm_train")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_grouped: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    libs = {}
    if args.parent is not None:
        kdir = args.parent / "src" / "repro_torch" / "kernels"
        parent = KernelLibrary("grouped_gemm_parent", kdir / "grouped_gemm"
                               / "csrc" / "grouped_gemm.cu",
                               include=kdir / "csrc")
        libs["parent"] = Entries(parent.load())
    libs["change"] = Entries(ops.LIBRARY.load())
    _emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "torch": torch.__version__, "libraries": list(libs),
           "ptxas": [ln.strip() for ln in ops.LIBRARY.ptxas_log.splitlines()
                     if "grouped_wgrad" in ln or "swiglu_bwd" in ln
                     or "matmul_nt" in ln
                     or "registers" in ln or "spill" in ln
                     or "warning" in ln.lower()]})
    bench = Bench(libs, args.iters, args.check, args.rounds)
    if not args.no_forward:
        bench_forward(bench)
    for name in filter(None, args.shapes.split(",")):
        bench_backward(bench, name, dw2=name == "glm_train")
    if args.split:
        bench_split(bench)
    if args.f32:
        f32_libs = {}
        if args.parent is not None:
            src = (args.parent / "src" / "repro_torch" / "kernels"
                   / "grouped_gemm" / "csrc" / "grouped_gemm_bwd_f32.cu")
            lib = KernelLibrary("grouped_gemm_bwd_f32_parent", src,
                                include=src.parents[2] / "csrc")
            f32_libs["parent"] = F32Entries(
                lib.load(), legacy="void* ws" not in src.read_text())
        f32_libs["change"] = F32Entries(ops.LIBRARY_BWD_F32.load(),
                                        legacy=False)
        _emit({"f32_ptxas": [
            ln.strip() for ln in ops.LIBRARY_BWD_F32.ptxas_log.splitlines()
            if "registers" in ln or "spill" in ln
            or "warning" in ln.lower()]})
        for name in args.f32.split(","):
            bench_backward_f32(f32_libs, name, args.iters, args.check,
                               args.rounds)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
