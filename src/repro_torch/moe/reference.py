"""Semantic MoE oracle: per-token dense expert compute, no parallelism.

Mirrors ``repro.moe.reference``: ``y_t = sum_k w_{t,k} FFN_{e_{t,k}}(x_t)
(+ shared expert)``.  It computes every expert on every token, so it is a
check, not a serving path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["swiglu", "moe_ref"]


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor) -> torch.Tensor:
    """SwiGLU FFN: (silu(x @ w1) * (x @ w3)) @ w2."""
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def moe_ref(x: torch.Tensor, expert_ids: torch.Tensor, weights: torch.Tensor,
            w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor, *,
            shared: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None
            ) -> torch.Tensor:
    """Dense per-token MoE.  x: (T, D); expert_ids/weights: (T, k);
    w1, w3: (E, D, F); w2: (E, F, D); shared: (D,F), (D,F), (F,D)."""
    h = torch.einsum("td,edf->etf", x, w1)
    g = torch.einsum("td,edf->etf", x, w3)
    out_all = torch.einsum("etf,efd->etd", F.silu(h) * g, w2)     # (E, T, D)
    sel = torch.gather(out_all.movedim(0, 1), 1,
                       expert_ids[:, :, None].expand(-1, -1, x.shape[-1]))
    y = (sel * weights[:, :, None].to(sel.dtype)).sum(dim=1)
    if shared is not None:
        y = y + swiglu(x, *shared)
    return y.to(x.dtype)
