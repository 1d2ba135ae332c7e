"""LM assembly: embedding, blocks, final norm, chunked prefill and decode.

Mirrors the serving half of ``repro.models.model``: :class:`LMParams`,
:func:`init_lm`, :func:`init_caches`, :func:`prefill_step` and
:func:`decode_step`.  The layers are a list (one block per layer) where the
JAX package stacks scanned segments; caches are one entry per layer, a
:class:`KVCache` for an attention layer and an :class:`SSMState` for a
Mamba layer.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, layer_kinds
from repro_torch.models.layers import embed, rms_norm, unembed
from repro_torch.models.transformer import (
    ParallelCtx,
    RuntimeConfig,
    init_block,
    init_cache_block,
)

__all__ = ["LMParams", "init_lm", "init_caches", "prefill_step",
           "decode_step"]


class LMParams(nn.Module):
    """embedding (V, D), one BlockParams per layer, final_norm (D,),
    lm_head (V, D) or None when tied."""

    def __init__(self, embedding, layers, final_norm, lm_head=None):
        super().__init__()
        self.embedding = nn.Parameter(embedding, requires_grad=False)
        self.layers = nn.ModuleList(layers)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.lm_head = None if lm_head is None else nn.Parameter(
            lm_head, requires_grad=False)

    def head(self) -> torch.Tensor:
        return self.embedding if self.lm_head is None else self.lm_head


def init_lm(cfg: ModelConfig, rcfg: RuntimeConfig, pctx: ParallelCtx,
            generator: torch.Generator, *, device="cuda") -> LMParams:
    """Random weights from ``generator`` (which must live on ``device``).

    On an EP group each rank draws every weight from the same seed and
    keeps its own experts of each MoE layer (``init_moe_params``), so the
    group's ranks together hold what one rank holds at ``ep_size == 1``."""
    if cfg.frontend != "none":
        raise ValueError(f"{cfg.name}: modality frontends are not ported yet")
    layers = [init_block(cfg, kind, rcfg, pctx, generator, device=device)
              for kind in layer_kinds(cfg)]
    D, V = cfg.d_model, cfg.vocab_size

    def normal(shape):
        return torch.randn(shape, generator=generator, dtype=rcfg.dtype,
                           device=device) * 0.02

    return LMParams(
        embedding=normal((V, D)), layers=layers,
        final_norm=torch.ones(D, dtype=rcfg.dtype, device=device),
        lm_head=None if cfg.tie_embeddings else normal((V, D)))


def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                rcfg: RuntimeConfig, *, device="cuda") -> list:
    """One decode cache per layer (KVCache or SSMState by the layer's kind)."""
    return [init_cache_block(cfg, kind, batch, max_seq, rcfg.dtype,
                             device=device) for kind in layer_kinds(cfg)]


def _run_layers(x, params: LMParams, caches, cfg, rcfg, pctx, *, decode,
                valid_len=None, router_bias=None):
    new_caches = []
    for i, (kind, bp, cache) in enumerate(zip(layer_kinds(cfg),
                                              params.layers, caches)):
        bias = None if router_bias is None else router_bias[i]
        x, _aux, _drops, _counts, nc = bp(
            x, kind, cfg, rcfg, pctx, cache=cache, router_bias=bias,
            decode=decode, valid_len=valid_len)
        new_caches.append(nc)
    return rms_norm(x, params.final_norm), new_caches


def prefill_step(params: LMParams, caches, tokens: torch.Tensor,
                 cfg: ModelConfig, rcfg: RuntimeConfig, pctx: ParallelCtx, *,
                 valid_len=None, router_bias: torch.Tensor | None = None):
    """Chunked prefill of a (B, C) chunk at the caches' offsets.

    Returns (logits (B, C, V) fp32, new_caches).
    """
    x = embed(tokens, params.embedding)
    x, new_caches = _run_layers(x, params, caches, cfg, rcfg, pctx,
                                decode=False, valid_len=valid_len,
                                router_bias=router_bias)
    return unembed(x, params.head()), new_caches


def decode_step(params: LMParams, caches, tokens: torch.Tensor,
                cfg: ModelConfig, rcfg: RuntimeConfig, pctx: ParallelCtx, *,
                router_bias: torch.Tensor | None = None):
    """One-token decode.  tokens: (B, 1).  Returns (logits, new_caches)."""
    x = embed(tokens, params.embedding)
    x, new_caches = _run_layers(x, params, caches, cfg, rcfg, pctx,
                                decode=True, router_bias=router_bias)
    return unembed(x, params.head()), new_caches

