"""Grouped expert FFN over physical slot buffers.

Mirrors the fp path of ``repro.moe.expert.grouped_ffn`` with
``use_kernel=True``: one fused grouped SwiGLU (gate and up projections from
one read of each x tile) and one grouped matmul (down projection), both
hand-written Hopper kernels (:mod:`repro_torch.kernels.grouped_gemm`).  On a
CPU tensor the wrappers run their plain PyTorch versions.  The w8a8 path is
not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.grouped_gemm import grouped_matmul, grouped_swiglu

__all__ = ["grouped_ffn"]


def grouped_ffn(xs: torch.Tensor, valid: torch.Tensor, w1: torch.Tensor,
                w3: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Per-slot SwiGLU.

    xs: (G, C, D) capacity-padded slot buffers; valid: (G, C) bool;
    w1, w3: (G, D, F); w2: (G, F, D).  Returns (G, C, D) in xs's dtype, zero
    on padded rows.
    """
    zero = torch.zeros((), dtype=xs.dtype, device=xs.device)
    xs = torch.where(valid[:, :, None], xs, zero)
    out = grouped_matmul(grouped_swiglu(xs, w1, w3), w2)
    return torch.where(valid[:, :, None], out, zero)
