"""Shared building blocks (mirrors ``repro.models.layers``): RMSNorm,
rotary embeddings, dense SwiGLU FFN, embedding lookup and fp32 unembedding."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["rms_norm", "rotary_cos_sin", "apply_rotary", "dense_swiglu",
           "embed", "unembed"]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32 accumulation."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.to(torch.float32)
    return out.to(x.dtype)


def rotary_cos_sin(positions: torch.Tensor, head_dim: int,
                   theta: float = 10000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., head_dim/2) cos/sin tables for the given positions."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (x1, x2) -> (x1 cos - x2 sin, x1 sin + x2 cos).

    x: (..., S, H, head_dim); cos/sin: (..., S, head_dim/2) broadcast over H.
    """
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)


def dense_swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                 w2: torch.Tensor) -> torch.Tensor:
    """Dense-FFN SwiGLU (the non-MoE feed-forward)."""
    return ((F.silu(x @ w1) * (x @ w3)) @ w2).to(x.dtype)


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Token embedding lookup, (B, S) -> (B, S, D).  Its backward
    (``embedding_dense_backward``) sums each row's gradients in fp32; the
    backward of ``table[tokens]`` accumulates in the table's dtype, one
    occurrence at a time: in bf16, over the ~2000 occurrences of a Zipf
    stream's top token in 8192, that drifts by a few bf16 steps (and took
    0.4 s of an H100 train step)."""
    return F.embedding(tokens, table)


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits in fp32: (B, S, D) @ (V, D)^T."""
    return torch.einsum("bsd,vd->bsv", x.to(torch.float32),
                        table.to(torch.float32))
