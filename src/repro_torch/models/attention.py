"""GQA attention with chunked prefill and a static-shape decode cache.

Mirrors the GQA half of ``repro.models.attention``.  Where the reference
calls ``flash_ref``, the port calls ``flash_attention`` with the same
arguments (``q_offset``, ``kv_valid_len``): the hand-written flash kernel
on a CUDA tensor, its plain version on a CPU tensor.  ``flash_ref`` (the
online-softmax reference over KV blocks in plain tensor ops) is that plain
version, re-exported from ``repro_torch.kernels.flash_attention``;
``block_kv`` is read by it only.  The prefill/decode functions write the
cache at each row's own offset.  MLA is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ops import (
    flash_attention_ref as flash_ref,
)
from repro_torch.models.layers import apply_rotary, rms_norm, rotary_cos_sin

__all__ = ["AttnConfig", "GQAParams", "KVCache", "flash_ref", "init_gqa",
           "gqa_attention", "gqa_prefill", "gqa_decode"]


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    causal: bool = True
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0


class GQAParams(nn.Module):
    """wq (D, H*hd), wk/wv (D, Hkv*hd), wo (H*hd, D); optional qkv biases
    and per-head q/k RMSNorm scales (mirrors ``repro.models.attention.GQAParams``)."""

    def __init__(self, wq, wk, wv, wo, bq=None, bk=None, bv=None,
                 q_norm=None, k_norm=None):
        super().__init__()
        for name, t in (("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo),
                        ("bq", bq), ("bk", bk), ("bv", bv),
                        ("q_norm", q_norm), ("k_norm", k_norm)):
            setattr(self, name, None if t is None
                    else nn.Parameter(t, requires_grad=False))

    def forward(self, x: torch.Tensor, cfg: AttnConfig, *, cache=None,
                decode: bool = False, valid_len=None, block_kv: int = 512):
        if decode:
            return gqa_decode(x, cache, self, cfg, block_kv=block_kv)
        if cache is not None:
            return gqa_prefill(x, cache, self, cfg, valid_len=valid_len,
                               block_kv=block_kv)
        return gqa_attention(x, self, cfg, block_kv=block_kv)


class KVCache(NamedTuple):
    """Decode-time cache: k/v (B, S, Hkv, hd), length (B,) filled positions."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor


def init_gqa(cfg: AttnConfig, generator: torch.Generator, *,
             dtype=torch.float32, device="cuda") -> GQAParams:
    D, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device) * scale

    def const(n, val):
        return torch.full((n,), val, dtype=dtype, device=device)

    s = D ** -0.5
    return GQAParams(
        wq=normal((D, H * hd), s), wk=normal((D, Hkv * hd), s),
        wv=normal((D, Hkv * hd), s),
        wo=normal((H * hd, D), (H * hd) ** -0.5),
        bq=const(H * hd, 0.0) if cfg.qkv_bias else None,
        bk=const(Hkv * hd, 0.0) if cfg.qkv_bias else None,
        bv=const(Hkv * hd, 0.0) if cfg.qkv_bias else None,
        q_norm=const(hd, 1.0) if cfg.qk_norm else None,
        k_norm=const(hd, 1.0) if cfg.qk_norm else None,
    )


def _update_at(cache_arr: torch.Tensor, new: torch.Tensor,
               lengths: torch.Tensor) -> torch.Tensor:
    """Write ``new`` (B, C, ...) into a copy of ``cache_arr`` (B, S, ...) at
    per-row offsets along axis 1, clamped so the update fits (the semantics
    of ``lax.dynamic_update_slice``)."""
    B, S = cache_arr.shape[:2]
    C = new.shape[1]
    start = lengths.to(torch.int64).clamp(0, S - C)
    idx = start[:, None] + torch.arange(C, device=cache_arr.device)[None, :]
    rows = torch.arange(B, device=cache_arr.device)[:, None]
    out = cache_arr.clone()
    out[rows, idx] = new.to(out.dtype)
    return out


def _project_gqa(x: torch.Tensor, params: GQAParams, cfg: AttnConfig):
    B, S, _ = x.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ params.wq
    k = x @ params.wk
    v = x @ params.wv
    if cfg.qkv_bias:
        q, k, v = q + params.bq, k + params.bk, v + params.bv
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, Hkv, hd)
    v = v.reshape(B, S, Hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params.q_norm)
        k = rms_norm(k, params.k_norm)
    return q, k, v


def gqa_attention(x: torch.Tensor, params: GQAParams, cfg: AttnConfig, *,
                  positions: torch.Tensor | None = None,
                  block_kv: int = 512) -> torch.Tensor:
    """Full-sequence GQA.  x: (B, S, D)."""
    B, S, _ = x.shape
    q, k, v = _project_gqa(x, params, cfg)
    pos = torch.arange(S, device=x.device) if positions is None else positions
    cos, sin = rotary_cos_sin(pos, cfg.head_dim, cfg.rope_theta)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    out = flash_attention(q, k, v, causal=cfg.causal, block_kv=block_kv)
    return out.reshape(B, S, -1) @ params.wo


def gqa_prefill(x: torch.Tensor, cache: KVCache, params: GQAParams,
                cfg: AttnConfig, *, valid_len=None, block_kv: int = 1024
                ) -> tuple[torch.Tensor, KVCache]:
    """Chunked prefill: attend a chunk against cache + itself, write cache.

    x: (B, C, D) starting at absolute position cache.length; ``valid_len``
    counts the chunk's real tokens (the rest is right padding).
    """
    B, C, _ = x.shape
    q, k, v = _project_gqa(x, params, cfg)
    pos = cache.length[:, None] + torch.arange(C, device=x.device)[None, :]
    cos, sin = rotary_cos_sin(pos, cfg.head_dim, cfg.rope_theta)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    k_all = _update_at(cache.k, k, cache.length)
    v_all = _update_at(cache.v, v, cache.length)
    vl = C if valid_len is None else valid_len
    out = flash_attention(q, k_all, v_all, causal=True, block_kv=block_kv,
                          q_offset=cache.length,
                          kv_valid_len=cache.length + vl)
    y = out.reshape(B, C, -1) @ params.wo
    return y, KVCache(k_all, v_all, cache.length + vl)


def gqa_decode(x: torch.Tensor, cache: KVCache, params: GQAParams,
               cfg: AttnConfig, *, block_kv: int = 1024
               ) -> tuple[torch.Tensor, KVCache]:
    """One-token decode with a static-shape KV cache.  x: (B, 1, D)."""
    B = x.shape[0]
    q, k, v = _project_gqa(x, params, cfg)
    pos = cache.length[:, None]
    cos, sin = rotary_cos_sin(pos, cfg.head_dim, cfg.rope_theta)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    k_all = _update_at(cache.k, k, cache.length)
    v_all = _update_at(cache.v, v, cache.length)
    out = flash_attention(q, k_all, v_all, causal=False, block_kv=block_kv,
                          kv_valid_len=cache.length + 1)
    y = out.reshape(B, 1, -1) @ params.wo
    return y, KVCache(k_all, v_all, cache.length + 1)
