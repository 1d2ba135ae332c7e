"""Fused router top-k: a hand-written Hopper kernel and its plain version.

``gating_topk`` replaces ``repro.kernels.gating_topk.kernel.
gating_topk_pallas``: per token row of router logits it computes the
softmax or sigmoid scores, k rounds of (max, argmax with the lowest expert
index on ties, mask) and the per-expert histogram of the selections.
With an aux-free selection bias (E,) (DeepSeek), the rounds select on
scores + bias and the weights stay the unbiased scores, as
``repro.moe.gating.gate`` does.  The
CUDA source is ``csrc/gating_topk.cu``; its header says what bounds the
kernel on an H100 and what the design does about it.

Dispatch is by the tensor's device only: a CPU tensor runs the plain
version, a CUDA tensor launches the kernel or raises.  The wrapper counts
its launches in ``gating_topk.launches``.  On the card one launch does
everything, the counts included (written, not accumulated: no zeroing),
and nothing is read back to the host, so a CUDA graph can capture the
call; the kernel's cross-block scratch is the wrapper's, one per (device,
stream) (see ``prepare_stream``).  The kernel's entry point decides its
launch geometry; ``launch_geometry`` and ``packed_topk`` mirror that and
the kernel's selection on the CPU for the tests.

Rack-limited routing (``num_racks`` G, ``rack_limit`` M, ``group_topk``
gk; DeepSeek-V3's node-limited routing, ``repro.moe.gating.
_rack_limited_top_k``): the rounds select among the experts of each row's
M best racks only, a rack (a contiguous block of E / G experts) scored by
the sum of its gk largest keys.  On a CUDA tensor a binding limit (M < G)
launches the kernel's rack mode (counted in ``launches_by_kernel["rack"]``
besides ``launches``) at every geometry the reference routes (G dividing
E, gk >= 1, k <= M E / G; :func:`rack_mode` says which of the kernel's two
paths takes it); M == G is free routing, bit for bit, and takes the free
kernel.  The plain version is :func:`rack_limited_ids`.

Shapes: logits (T, E) fp32 -> ids (T, k) int64 (the port's id dtype),
weights (T, k) fp32 (the raw selected scores: the caller renormalises),
counts (E,) int64 and, when asked, scores (T, E) fp32.

Gradient.  With a gradient required of the logits, the call is an autograd
Function: the forward is the same one launch (or the plain version), and
the backward, in PyTorch ops, scatters d(weights) at the selected ids into
(T, E), adds d(scores) and applies the softmax or sigmoid Jacobian (one
(T, E) pass; the JAX package differentiates ``lax.top_k`` and the gather
the same way, with no kernel).  The ids and counts carry no gradient, and
neither does the bias, which only steers the selection.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import KernelLibrary

__all__ = ["gating_topk", "gating_topk_ref", "scores_of", "prepare_stream",
           "release_scratch", "launch_geometry", "packed_keys", "packed_topk",
           "rack_limited_ids", "rack_mode", "LIBRARY"]

LIBRARY = KernelLibrary("gating_topk",
                        Path(__file__).parent / "csrc" / "gating_topk.cu")

_SCORE_FN = {"softmax": 0, "sigmoid": 1}
MAX_EXPERTS = 256
MAX_K = 8


def scores_of(logits: torch.Tensor, score_fn: str) -> torch.Tensor:
    """Router scores in fp32 (fp64 for fp64 logits): softmax or sigmoid
    over the expert axis."""
    x = logits.to(torch.promote_types(logits.dtype, torch.float32))
    if score_fn == "softmax":
        return torch.softmax(x, dim=-1)
    if score_fn == "sigmoid":
        return torch.sigmoid(x)
    raise ValueError(f"unknown score_fn {score_fn}")


def _top(x: torch.Tensor, k: int) -> torch.Tensor:
    """``lax.top_k``'s indices: a stable descending sort, the lower index
    first among equal values."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def rack_limited_ids(keys: torch.Tensor, k: int, num_racks: int,
                     rack_limit: int, group_topk: int) -> torch.Tensor:
    """Group-limited top-k (mirrors ``repro.moe.gating._rack_limited_top_k``).

    Per row of ``keys`` (T, E): each rack (a block of E / G experts) scores
    the sum of its ``group_topk`` largest keys (in descending order), the
    ``rack_limit`` best racks are kept (the lower rack first among equal
    scores), every other rack's keys become -inf, and the ordinary top-k
    follows.  At ``rack_limit == num_racks`` the keys are unchanged."""
    T, E = keys.shape
    G, M = num_racks, rack_limit
    epg = E // G
    gk = min(group_topk, epg)
    grp = torch.sort(keys.reshape(T, G, epg), dim=-1,
                     descending=True).values[..., :gk]
    score = grp[..., 0]
    for i in range(1, gk):
        score = score + grp[..., i]
    racks = _top(score, M)                                      # (T, M)
    live = torch.zeros((T, G), dtype=torch.bool, device=keys.device)
    live.scatter_(1, racks, True)
    masked = torch.where(live.repeat_interleave(epg, dim=1), keys,
                         torch.full((), float("-inf"), dtype=keys.dtype,
                                    device=keys.device))
    return _top(masked, k)


def rack_mode(E: int, k: int, num_racks: int, rack_limit: int,
              group_topk: int) -> tuple[int, int]:
    """The kernel's rack-mode path (``gating_topk_rack_mode`` in the CUDA
    source) and its lanes a rack: (0, 0) for free routing (one rack, no
    limit, or a limit that does not bind); (1, L) where a rack is L aligned
    lanes of PER experts (L a power of two) and the clamped group top-k is
    at most PER (the lanes path); (2, 0) for every other geometry (the
    shared-memory path); (-1, 0) where the reference does not route either
    (G not dividing E, a group top-k below 1, k above M E / G)."""
    if num_racks <= 1 or rack_limit <= 0 or rack_limit >= num_racks:
        return 0, 0
    if E % num_racks or group_topk < 1:
        return -1, 0
    epg = E // num_racks
    if k > rack_limit * epg:
        return -1, 0
    per = 4 if E <= 128 else 8
    L = epg // per
    if epg % per == 0 and not L & (L - 1) and min(group_topk, epg) <= per:
        return 1, L
    return 2, 0


def gating_topk_ref(logits: torch.Tensor, k: int, *, score_fn: str,
                    bias: torch.Tensor | None = None,
                    want_scores: bool = False, num_racks: int = 1,
                    rack_limit: int = 0, group_topk: int = 2):
    """Plain version: scores, a stable descending sort of the scores (plus
    ``bias``) cut to k (the lower expert index first among equal keys, as
    ``lax.top_k``), the unbiased scores gathered, bincount.  With a rack
    limit (``0 < rack_limit``, ``num_racks > 1``) the selection is
    :func:`rack_limited_ids`."""
    scores = scores_of(logits, score_fn)
    keys = scores if bias is None else scores + bias.to(torch.float32)[None, :]
    if num_racks > 1 and rack_limit > 0:
        ids = rack_limited_ids(keys, k, num_racks, rack_limit, group_topk)
    else:
        ids = _top(keys, k)
    weights = torch.gather(scores, 1, ids)
    counts = torch.bincount(ids.reshape(-1), minlength=logits.shape[1])
    return (ids, weights, counts) + ((scores,) if want_scores else ())


# A mirror of the kernel's launch geometry, which its entry point decides
# (``plan`` in the CUDA source; the card tests hold the two equal through
# ``gating_topk_plan``): a row per group of G lanes, at most 32 rows a
# block and pass (32 whenever the grid has more than one block), the grid
# capped at MAX_BLOCKS.
MAX_ROWS = 32
MAX_BLOCKS = 256
# The scratch: a 16-byte head (word 0: the ticket), then the accumulator
# of the blocks' histograms (E int32 words).
SCRATCH_HEAD = 4
SCRATCH_INTS = SCRATCH_HEAD + MAX_EXPERTS


@functools.lru_cache(maxsize=256)
def launch_geometry(T: int, E: int, k: int) -> tuple[int, int, int, int]:
    """(G lanes a row, experts a lane, rows a block, blocks) for logits
    (T, E), top-k: the kernel's choice, mirrored for ``packed_topk`` and the
    tests.

    A lane holds one 16-byte chunk of the row (two past E 128), and G is
    the smallest power of two with a lane for each chunk and for each of
    the k selections: 32 at E 128 and 256, 4 at E 16.  A block takes 32
    rows, or all T rows (in whole warps) when T is smaller."""
    per = 4 if E <= 128 else 8
    group = 1 << (max(k, -(-E // per)) - 1).bit_length()
    per_warp = 32 // group
    rows = min(MAX_ROWS, max(per_warp, -(-T // per_warp) * per_warp))
    blocks = max(1, min(-(-T // rows), MAX_BLOCKS))
    return group, per, rows, blocks


def _order_bits(keys: torch.Tensor) -> torch.Tensor:
    """fp32 keys as int64 in [0, 2**32) whose order is the float order,
    -0.0 equal to +0.0 (the kernel's ``order_bits``)."""
    keys = torch.where(keys == 0, torch.zeros_like(keys), keys)
    u = keys.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 2 ** 31, 0xFFFFFFFF - u, u + 2 ** 31)


def packed_keys(keys: torch.Tensor) -> torch.Tensor:
    """The kernel's 64-bit selection words for keys (T, E) fp32, as int64
    with the same order: the key's order bits in the high half, the
    complement of the expert index in the low half, so one max picks the
    larger key and, among equal keys, the lower index."""
    e = torch.arange(keys.shape[-1], dtype=torch.int64, device=keys.device)
    return (_order_bits(keys) - 2 ** 31) * 2 ** 32 + (0xFFFFFFFF - e)


def packed_topk(keys: torch.Tensor, k: int) -> torch.Tensor:
    """A CPU mirror of the kernel's selection, used by the tests only: the
    row's experts laid out over its G lanes as the kernel holds them
    (16-byte chunks r, r + G, ...; -inf past E), each lane's packed words
    sorted, then k rounds of: the largest key among the lanes' heads, the
    lowest index among the heads that hold it (the two halves of the
    kernel's group max), and that lane's head dropped.  Returns the ids
    (T, k) int64."""
    T, E = keys.shape
    group, per, _, _ = launch_geometry(T, E, k)
    width = group * per
    padded = torch.full((T, width), float("-inf"), dtype=torch.float32)
    padded[:, :E] = keys.to(torch.float32)
    words = packed_keys(padded)                  # (T, width), index = expert
    # lanes[t, r, 4 j + q] = words[t, 4 (r + G j) + q]
    lanes = words.view(T, per // 4, group, 4).transpose(1, 2).reshape(
        T, group, per).clone()
    lanes = lanes.sort(dim=2, descending=True).values
    cleared = torch.iinfo(torch.int64).min
    ids = []
    for _ in range(k):
        heads = lanes[:, :, 0]                                # (T, G)
        hi, lo = heads >> 32, heads & 0xFFFFFFFF
        mh = hi.max(dim=1, keepdim=True).values
        ml = torch.where(hi == mh, lo, torch.full_like(lo, -1)).max(
            dim=1, keepdim=True).values
        ids.append((0xFFFFFFFF - ml)[:, 0])
        won = ((hi == mh) & (lo == ml))[:, :, None]
        lanes = torch.where(won, torch.cat(
            [lanes[:, :, 1:], torch.full_like(lanes[:, :, :1], cleared)],
            dim=2), lanes)
    return torch.stack(ids, dim=1)


def _is_cuda(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch), False for CPU (plain version)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no gating top-k for device {x.device}")


_SCRATCH: dict[tuple[int, int], torch.Tensor] = {}


@functools.cache
def _library():
    """The C entry points, their ctypes signatures set once, at load."""
    lib = LIBRARY.load()
    lib.gating_topk_plan.restype = None
    lib.gating_topk_plan.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.gating_topk_launch.restype = ctypes.c_int
    lib.gating_topk_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
        + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.gating_topk_rack_mode.restype = ctypes.c_int
    lib.gating_topk_rack_mode.argtypes = [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_int)]
    return lib


def kernel_plan(T: int, E: int, k: int) -> tuple[int, ...]:
    """The kernel's own (G, experts a lane, rows a block, blocks, scratch
    int32 words) for logits (T, E), top-k, from its entry point."""
    out = (ctypes.c_int * 5)()
    _library().gating_topk_plan(T, E, k, out)
    return tuple(out)


def kernel_rack_mode(E: int, k: int, num_racks: int, rack_limit: int,
                     group_topk: int) -> tuple[int, int]:
    """The kernel's own (path, lanes a rack) for a rack geometry, from its
    entry point (:func:`rack_mode` mirrors it)."""
    lanes = ctypes.c_int(0)
    mode = _library().gating_topk_rack_mode(E, k, num_racks, rack_limit,
                                            group_topk, ctypes.byref(lanes))
    return mode, lanes.value


def prepare_stream(stream: torch.cuda.Stream | None = None) -> torch.Tensor:
    """Make the kernel's scratch for launches on ``stream`` (the current
    stream by default) and return it: the ticket and the blocks' histogram
    accumulator.

    Made once per (device, stream), zeroed; every launch that uses it
    leaves it zero again, so no call zeroes anything.  Two
    launches on one stream share it safely because they run one after the
    other; launches on two streams use two scratches.  The first call on a
    stream makes it, but not inside a CUDA-graph capture (its zeroing would
    run only when the graph replays): a graph path calls this for its
    capture stream first and captures with ``torch.cuda.graph(g,
    stream=s)``.  A graph keeps the scratch of the stream it was captured
    on, so replay it where no other launch on that stream runs at the same
    time.  A scratch is 1 KB, kept until ``release_scratch``."""
    if stream is None:
        stream = torch.cuda.current_stream()
    return _scratch(stream.device, stream.cuda_stream)


def release_scratch() -> None:
    """Drop every stream's scratch.  Only when no captured graph that holds
    one will replay again: the graph keeps the raw pointer."""
    _SCRATCH.clear()


def _scratch(dev: torch.device, stream: int) -> torch.Tensor:
    key = (dev.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "gating_topk: the first call on a stream cannot be inside a "
                "CUDA graph capture; call ops.prepare_stream(s) for the "
                "capture stream s first and capture with "
                "torch.cuda.graph(g, stream=s)")
        buf = torch.zeros(kernel_plan(0, 1, 1)[4], dtype=torch.int32,
                          device=dev)
        _SCRATCH[key] = buf
    return buf


def _launch(logits: torch.Tensor, k: int, score_fn: str, bias,
            want_scores: bool, racks: tuple[int, int, int] = (1, 0, 2)):
    """Validate, allocate the outputs and launch on the current stream.
    Nothing here reads the device back, so the call can be captured in a
    CUDA graph."""
    if logits.dim() != 2 or logits.dtype != torch.float32:
        raise TypeError("gating_topk takes fp32 logits (T, E)")
    if score_fn not in _SCORE_FN:
        raise ValueError(f"unknown score_fn {score_fn}")
    T, E = logits.shape
    if not (1 <= E <= MAX_EXPERTS and 1 <= k <= min(MAX_K, E)):
        raise ValueError(f"gating_topk kernel takes E <= {MAX_EXPERTS} and "
                         f"k <= {MAX_K} (k <= E), not E={E}, k={k}")
    if logits.stride(1) != 1:
        raise ValueError("gating_topk needs unit-stride expert logits")
    if rack_mode(E, k, *racks)[0] < 0:
        raise ValueError(
            f"gating_topk's rack mode takes num_racks dividing E, a group "
            f"top-k of at least 1 and k <= rack_limit * E / num_racks, not "
            f"E={E}, k={k}, (num_racks, rack_limit, group_topk)={racks}")
    dev = logits.device
    if bias is not None:
        if bias.shape != (E,) or bias.device != dev:
            raise ValueError(f"bias must be ({E},) on {dev}, not "
                             f"{tuple(bias.shape)} on {bias.device}")
        bias = bias.to(torch.float32).contiguous()
    # new_empty: the cheapest allocation on the host (measured against
    # torch.empty(device=...) and against views of two shared buffers).
    ids = logits.new_empty((T, k), dtype=torch.int64)
    weights = logits.new_empty((T, k))
    counts = logits.new_empty((E,), dtype=torch.int64)
    scores = logits.new_empty((T, E)) if want_scores else None
    # The raw handle of the current stream (torch.cuda.current_stream()
    # builds a Stream object, several microseconds of host time a call).
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    scratch = _scratch(dev, stream)
    err = _library().gating_topk_launch(
        _SCORE_FN[score_fn], logits.data_ptr(),
        None if bias is None else bias.data_ptr(), ids.data_ptr(),
        weights.data_ptr(), counts.data_ptr(),
        None if scores is None else scores.data_ptr(),
        scratch.data_ptr(), T, E, k, logits.stride(0), *racks, stream)
    if err != 0:
        raise RuntimeError(f"gating_topk kernel launch failed: CUDA error "
                           f"{err}")
    return ids, weights, counts, scores


def gating_topk(logits: torch.Tensor, k: int, *, score_fn: str = "softmax",
                bias: torch.Tensor | None = None, want_scores: bool = False,
                num_racks: int = 1, rack_limit: int = 0, group_topk: int = 2):
    """Scores, top-k and histogram of router logits (T, E).

    ``bias`` (E,), if given, steers the selection only.  ``num_racks``,
    ``rack_limit`` and ``group_topk``: rack-limited routing (the module's
    notes).  Returns ``(ids, weights, counts)``, plus ``scores`` (T, E)
    fp32 when ``want_scores``; on a CUDA tensor the scores are written by
    the same pass that selects.  Differentiable in the logits (weights and
    scores)."""
    racks = (num_racks, rack_limit, group_topk)
    if torch.is_grad_enabled() and logits.requires_grad:
        out = _GatingTopK.apply(logits, k, score_fn,
                                None if bias is None else bias.detach(), racks)
        return out if want_scores else out[:3]
    return _topk(logits, k, score_fn, bias, want_scores, racks)


def _topk(logits, k, score_fn, bias, want_scores, racks):
    if not _is_cuda(logits):
        return gating_topk_ref(logits, k, score_fn=score_fn, bias=bias,
                               want_scores=want_scores, num_racks=racks[0],
                               rack_limit=racks[1], group_topk=racks[2])
    ids, weights, counts, scores = _launch(logits, k, score_fn, bias,
                                           want_scores, racks)
    gating_topk.launches += 1
    kernel = "rack" if rack_mode(logits.shape[1], k, *racks)[0] else "free"
    gating_topk.launches_by_kernel[kernel] += 1
    return (ids, weights, counts) + ((scores,) if want_scores else ())


gating_topk.launches = 0
gating_topk.launches_by_kernel = {"free": 0, "rack": 0}


class _GatingTopK(torch.autograd.Function):
    """(ids, weights, counts, scores) of the logits; saves ids and scores."""

    @staticmethod
    def forward(ctx, logits, k, score_fn, bias, racks):
        ids, weights, counts, scores = _topk(logits, k, score_fn, bias, True,
                                             racks)
        ctx.save_for_backward(ids, scores)
        ctx.score_fn = score_fn
        ctx.mark_non_differentiable(ids, counts)
        return ids, weights, counts, scores

    @staticmethod
    def backward(ctx, _dids, dweights, _dcounts, dscores):
        ids, scores = ctx.saved_tensors
        d = (torch.zeros_like(scores) if dscores is None
             else dscores.to(scores.dtype).clone())
        if dweights is not None:
            d.scatter_add_(1, ids, dweights.to(scores.dtype))
        if ctx.score_fn == "softmax":
            dl = scores * (d - (d * scores).sum(dim=-1, keepdim=True))
        else:
            dl = d * scores * (1 - scores)
        return dl, None, None, None, None
