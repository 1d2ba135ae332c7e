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
its launches in ``gating_topk.launches``.

Shapes: logits (T, E) fp32 -> ids (T, k) int64 (the port's id dtype),
weights (T, k) fp32 (the raw selected scores: the caller renormalises),
counts (E,) int64 and, when asked, scores (T, E) fp32.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import KernelLibrary

__all__ = ["gating_topk", "gating_topk_ref", "scores_of", "LIBRARY"]

LIBRARY = KernelLibrary("gating_topk",
                        Path(__file__).parent / "csrc" / "gating_topk.cu")

_SCORE_FN = {"softmax": 0, "sigmoid": 1}
MAX_EXPERTS = 256
MAX_K = 8


def scores_of(logits: torch.Tensor, score_fn: str) -> torch.Tensor:
    """Router scores in fp32: softmax or sigmoid over the expert axis."""
    if score_fn == "softmax":
        return torch.softmax(logits.to(torch.float32), dim=-1)
    if score_fn == "sigmoid":
        return torch.sigmoid(logits.to(torch.float32))
    raise ValueError(f"unknown score_fn {score_fn}")


def gating_topk_ref(logits: torch.Tensor, k: int, *, score_fn: str,
                    bias: torch.Tensor | None = None,
                    want_scores: bool = False):
    """Plain version: scores, a stable descending sort of the scores (plus
    ``bias``) cut to k (the lower expert index first among equal keys, as
    ``lax.top_k``), the unbiased scores gathered, bincount."""
    scores = scores_of(logits, score_fn)
    keys = scores if bias is None else scores + bias.to(torch.float32)[None, :]
    ids = torch.sort(keys, dim=-1, descending=True, stable=True).indices[:, :k]
    weights = torch.gather(scores, 1, ids)
    counts = torch.bincount(ids.reshape(-1), minlength=logits.shape[1])
    return (ids, weights, counts) + ((scores,) if want_scores else ())


def _is_cuda(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch), False for CPU (plain version)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no gating top-k for device {x.device}")


def _launch(logits: torch.Tensor, k: int, score_fn: str, bias,
            want_scores: bool):
    """Validate, allocate the outputs and launch on the current stream."""
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
    dev = logits.device
    if bias is not None:
        if bias.shape != (E,) or bias.device != dev:
            raise ValueError(f"bias must be ({E},) on {dev}, not "
                             f"{tuple(bias.shape)} on {bias.device}")
        bias = bias.to(torch.float32).contiguous()
    ids = torch.empty((T, k), dtype=torch.int64, device=dev)
    weights = torch.empty((T, k), dtype=torch.float32, device=dev)
    counts = torch.zeros((E,), dtype=torch.int64, device=dev)
    scores = (torch.empty((T, E), dtype=torch.float32, device=dev)
              if want_scores else None)
    if T == 0:
        return ids, weights, counts, scores, False
    fn = LIBRARY.load().gating_topk_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(_SCORE_FN[score_fn], logits.data_ptr(),
             None if bias is None else bias.data_ptr(), ids.data_ptr(),
             weights.data_ptr(), counts.data_ptr(),
             0 if scores is None else scores.data_ptr(), T, E, k,
             logits.stride(0), stream)
    if err != 0:
        raise RuntimeError(f"gating_topk kernel launch failed: CUDA error "
                           f"{err}")
    return ids, weights, counts, scores, True


def gating_topk(logits: torch.Tensor, k: int, *, score_fn: str = "softmax",
                bias: torch.Tensor | None = None, want_scores: bool = False):
    """Scores, top-k and histogram of router logits (T, E).

    ``bias`` (E,), if given, steers the selection only.  Returns ``(ids,
    weights, counts)``, plus ``scores`` (T, E) fp32 when ``want_scores``;
    on a CUDA tensor the scores are written by the same pass that
    selects."""
    if not _is_cuda(logits):
        return gating_topk_ref(logits, k, score_fn=score_fn, bias=bias,
                               want_scores=want_scores)
    ids, weights, counts, scores, launched = _launch(logits, k, score_fn,
                                                     bias, want_scores)
    if launched:
        gating_topk.launches += 1
    return (ids, weights, counts) + ((scores,) if want_scores else ())


gating_topk.launches = 0
