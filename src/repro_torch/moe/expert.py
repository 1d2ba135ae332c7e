"""Grouped expert FFN over physical slot buffers.

Mirrors ``repro.moe.expert.grouped_ffn`` with ``use_kernel=True``.  The fp
path is one fused grouped SwiGLU (gate and up projections from one read of
each x tile) and one grouped matmul (down projection); ``ffn_dtype="int8"``
is the w8a8 path of DESIGN.md S12: activations quantized per token row,
weights per (slot, out-feature) column over the contraction axis, both GEMMs
accumulating in int32 with a rank-1 dequant, the gate and the requantization
between the GEMMs in fp32.  All four GEMMs are hand-written Hopper kernels
(:mod:`repro_torch.kernels.grouped_gemm`); on a CPU tensor the wrappers run
their plain PyTorch versions.

The fp path is differentiable in xs, w1, w3 and w2 (the grouped kernels'
autograd Functions and their backward kernels); the w8a8 path has no
backward and raises a ``ValueError`` when a gradient is required.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantize import abs_max, encode_int8, quantize_rows
from repro_torch.kernels.grouped_gemm import (
    grouped_matmul,
    grouped_matmul_q8,
    grouped_swiglu,
    grouped_swiglu_q8,
)

__all__ = ["grouped_ffn", "quantize_weight_cols"]


def quantize_weight_cols(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(group, out-feature) symmetric int8 over the contraction axis.

    ``w``: (G, K, N) -> (codes int8 (G, K, N), scales fp32 (G, N)).
    """
    scales = abs_max(w, 1) / 127.0
    return encode_int8(w, scales[:, None, :]), scales


def grouped_ffn(xs: torch.Tensor, valid: torch.Tensor, w1: torch.Tensor,
                w3: torch.Tensor, w2: torch.Tensor, *, ffn_dtype: str = "none",
                xs_scale: torch.Tensor | None = None,
                wq: tuple | None = None,
                rows: torch.Tensor | None = None,
                plain_backward: bool = False) -> torch.Tensor:
    """Per-slot SwiGLU.

    xs: (G, C, D) capacity-padded slot buffers, fp activations or int8 wire
    codes with their fp32 row scales ``xs_scale`` (G, C); valid: (G, C)
    bool, the prefix ``arange(C) < rows`` of each slot as the buckets of
    :mod:`repro_torch.moe.permute` build it; rows: (G,) each slot's
    valid-row count (the buckets return it; when not given, each slot's
    last valid row, with the rows ``valid`` excludes zeroed, for either
    ``ffn_dtype``); w1, w3: (G, D, F); w2: (G, F, D).  Both paths hand
    ``rows`` to both kernels, which compute only the valid rows and write
    exact zeros past them on the device, whatever xs (and xs_scale) hold
    there; the w8a8 down projection writes the output dtype directly.  ``wq``, for
    ``ffn_dtype="int8"`` only, is ``((w1q, w1s), (w3q, w3s), (w2q, w2s))``,
    equal to :func:`quantize_weight_cols` of w1, w3, w2 (the layer keeps
    them, so the weights are not quantized on every call); without it they
    are quantized here, as the reference does.  Returns (G, C, D) in xs's
    dtype, or w1's when xs arrived as int8, zero on padded rows.
    ``plain_backward``: the fp path's backward as autograd through the
    kernels' plain versions (see :mod:`repro_torch.kernels.grouped_gemm`).
    """
    out_dtype = w1.dtype if xs.dtype == torch.int8 else xs.dtype
    if ffn_dtype not in ("none", "int8"):
        raise ValueError(f"unknown ffn_dtype: {ffn_dtype!r}")
    # The reference zeroes padded rows before the FFN (and after it); here
    # the kernels take ``rows`` and write exact zeros past each count,
    # whatever the activations (and scales) hold there: each output row
    # depends on its own input row only, so the valid rows are the
    # reference's.  A caller without the buckets' counts may pass any mask,
    # as the reference allows: the rows it excludes are zeroed (a zero row
    # gives a zero output row) and each slot runs to its last valid row.
    if rows is None:
        last = valid * torch.arange(1, valid.shape[1] + 1, device=valid.device)
        rows = last.amax(dim=1)
        if xs.dtype == torch.int8:
            xs_scale = torch.where(valid, xs_scale, torch.zeros(
                (), dtype=xs_scale.dtype, device=xs_scale.device))
        else:
            xs = torch.where(valid[:, :, None], xs,
                             torch.zeros((), dtype=xs.dtype, device=xs.device))
    if ffn_dtype == "none":
        act = grouped_swiglu(xs, w1, w3, rows, plain_backward=plain_backward)
        return grouped_matmul(act, w2, rows, plain_backward=plain_backward)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xs, w1, w3, w2)):
        raise ValueError("ffn_dtype='int8' has no backward: train with "
                         "ffn_dtype='none'")
    if xs.dtype != torch.int8:
        xs, xs_scale = quantize_rows(xs)
    (w1q, w1s), (w3q, w3s), (w2q, w2s) = (
        wq if wq is not None else map(quantize_weight_cols, (w1, w3, w2)))
    act = grouped_swiglu_q8(xs, xs_scale, w1q, w1s, w3q, w3s, rows)
    aq, as_ = quantize_rows(act)
    return grouped_matmul_q8(aq, as_, w2q, w2s, rows, out_dtype=out_dtype)
