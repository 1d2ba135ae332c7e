"""LM assembly: embedding, blocks, final norm, losses, chunked prefill and
decode.

Mirrors ``repro.models.model``: :class:`LMParams`, :func:`init_lm`,
:func:`init_router_bias`, the full-sequence :func:`forward` and the losses
:func:`lm_loss` and :func:`blocked_lm_loss` (training), :func:`init_caches`,
:func:`prefill_step` and :func:`decode_step` (serving), :func:`param_count`.
The modality frontends are the reference's stubs: a (D, D) projection,
``frontend_proj``, of precomputed frame embeddings (``audio_frames``: the
input is ``batch["frames"]`` (B, S, D), no tokens) or of patch embeddings
spliced over the first P positions of the token embeddings
(``vision_patches``: ``batch["patches"]`` (B, P, D)); :func:`forward` takes
them, while :func:`prefill_step` and :func:`decode_step` embed tokens only,
as the JAX ones do.  The layers are a list (one block per layer) where the
JAX package stacks scanned segments; caches are one entry per layer, a
:class:`KVCache` for an attention layer and an :class:`SSMState` for a
Mamba layer.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.configs.base import ModelConfig, layer_kinds
from repro_torch.models.layers import embed, rms_norm, unembed
from repro_torch.models.transformer import (
    ParallelCtx,
    RuntimeConfig,
    init_block,
    init_cache_block,
)

__all__ = ["LMParams", "init_lm", "init_router_bias", "forward", "lm_loss",
           "blocked_lm_loss", "init_caches", "prefill_step", "decode_step",
           "param_count"]


class LMParams(nn.Module):
    """embedding (V, D), one BlockParams per layer, final_norm (D,),
    lm_head (V, D) or None when tied, frontend_proj (D, D) for a modality
    frontend stub or None.  Built with ``requires_grad=False`` (serving);
    ``requires_grad_(True)`` makes every parameter trainable
    (``repro_torch.train.loop.init_train_state`` does)."""

    def __init__(self, embedding, layers, final_norm, lm_head=None,
                 frontend_proj=None):
        super().__init__()
        self.embedding = nn.Parameter(embedding, requires_grad=False)
        self.layers = nn.ModuleList(layers)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.lm_head = None if lm_head is None else nn.Parameter(
            lm_head, requires_grad=False)
        self.frontend_proj = None if frontend_proj is None else nn.Parameter(
            frontend_proj, requires_grad=False)

    def head(self) -> torch.Tensor:
        return self.embedding if self.lm_head is None else self.lm_head


def init_lm(cfg: ModelConfig, rcfg: RuntimeConfig, pctx: ParallelCtx,
            generator: torch.Generator, *, device="cuda") -> LMParams:
    """Random weights from ``generator`` (which must live on ``device``).

    On an EP group each rank draws every weight from the same seed and
    keeps its own experts of each MoE layer (``init_moe_params``), so the
    group's ranks together hold what one rank holds at ``ep_size == 1``.
    A frontend stub's projection, N(0, 1 / D) as the reference's, is drawn
    last."""
    layers = [init_block(cfg, kind, rcfg, pctx, generator, device=device)
              for kind in layer_kinds(cfg)]
    D, V = cfg.d_model, cfg.vocab_size

    def normal(shape, std=0.02):
        return torch.randn(shape, generator=generator, dtype=rcfg.dtype,
                           device=device) * std

    embedding = normal((V, D))
    lm_head = None if cfg.tie_embeddings else normal((V, D))
    return LMParams(
        embedding=embedding, layers=layers,
        final_norm=torch.ones(D, dtype=rcfg.dtype, device=device),
        lm_head=lm_head,
        frontend_proj=(None if cfg.frontend == "none"
                       else normal((D, D), D ** -0.5)))


def init_router_bias(cfg: ModelConfig, *, device="cuda"
                     ) -> torch.Tensor | None:
    """(num_layers, E) aux-free routing bias (zeros for non-MoE layers)."""
    if cfg.moe is None or not cfg.moe.use_bias:
        return None
    return torch.zeros((cfg.num_layers, cfg.moe.num_experts),
                       dtype=torch.float32, device=device)


def _input_embeddings(params: LMParams, batch: dict,
                      cfg: ModelConfig) -> torch.Tensor:
    """Embed the tokens, or take the stub frontend's embeddings: frames
    (B, S, D) through ``frontend_proj``, or projected patches (B, P, D)
    over the first P token positions (mirrors the reference's
    ``_input_embeddings``).  The stub's inputs are cast to the
    projection's dtype."""
    proj = params.frontend_proj
    if cfg.frontend == "audio_frames":
        return batch["frames"].to(proj.dtype) @ proj
    x = embed(batch["tokens"], params.embedding)
    if cfg.frontend == "vision_patches":
        patches = batch["patches"].to(proj.dtype) @ proj          # (B, P, D)
        x = torch.cat([patches.to(x.dtype), x[:, patches.shape[1]:]], dim=1)
    return x


def forward(params: LMParams, batch: dict, cfg: ModelConfig,
            rcfg: RuntimeConfig, pctx: ParallelCtx, *,
            router_bias: torch.Tensor | None = None,
            return_hidden: bool = False):
    """Full-sequence forward of ``batch["tokens"]`` (B, S), or of a stub
    frontend's ``batch["frames"]`` / ``batch["patches"]``.

    Returns (logits, aux_loss, drops, counts) where counts is the
    (num_layers, E) realized per-layer expert load (zeros on non-MoE
    layers); ``return_hidden=True`` returns the final-norm hidden states in
    place of the fp32 logits (the blocked-loss path).

    Under a gradient with ``rcfg.remat`` each layer runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``): its
    input is kept and the layer runs again in the backward, kernels and
    (on a mesh) EP collectives included, in the same order on every rank.
    aux, drops and counts are this forward's; the recompute's copies feed
    only the gradient.  No layer draws random numbers."""
    x = _input_embeddings(params, batch, cfg)
    dev = x.device
    aux_tot = torch.zeros((), dtype=torch.float32, device=dev)
    drops_tot = torch.zeros((), dtype=torch.int64, device=dev)
    counts = []
    remat = rcfg.remat and torch.is_grad_enabled()
    for i, (kind, bp) in enumerate(zip(layer_kinds(cfg), params.layers)):
        bias = None if router_bias is None else router_bias[i]
        if remat:
            x, aux, drops, c, _ = torch.utils.checkpoint.checkpoint(
                bp, x, kind, cfg, rcfg, pctx, router_bias=bias,
                use_reentrant=False)
        else:
            x, aux, drops, c, _ = bp(x, kind, cfg, rcfg, pctx,
                                     router_bias=bias)
        aux_tot = aux_tot + aux
        drops_tot = drops_tot + drops
        counts.append(c)
    x = rms_norm(x, params.final_norm)
    counts = torch.stack(counts)
    if return_hidden:
        return x, aux_tot, drops_tot, counts
    return unembed(x, params.head()), aux_tot, drops_tot, counts


def lm_loss(logits: torch.Tensor, targets: torch.Tensor, *,
            z_loss: float = 1e-4) -> torch.Tensor:
    """Token cross-entropy (fp32) with z-loss regularisation."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, targets[..., None].to(torch.int64))[..., 0]
    return (lse - ll).mean() + z_loss * (lse ** 2).mean()


def _chunk_terms(xc: torch.Tensor, head32: torch.Tensor, tc: torch.Tensor):
    logits = torch.einsum("bsd,vd->bsv", xc.to(torch.float32), head32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, tc[..., None].to(torch.int64))[..., 0]
    return (lse - ll).sum(), (lse ** 2).sum()


def blocked_lm_loss(x: torch.Tensor, head: torch.Tensor,
                    targets: torch.Tensor, *, z_loss: float = 1e-4,
                    chunks: int = 8) -> torch.Tensor:
    """Cross-entropy over sequence chunks without materialising the full
    (B, S, V) fp32 logits: each chunk's logits are recomputed in the
    backward (``torch.utils.checkpoint``, the reference's
    ``jax.checkpoint``).  The head is cast to fp32 once, so its gradient
    accumulates over the chunks in fp32."""
    B, S, _ = x.shape
    chunks = max(1, min(chunks, S))
    while S % chunks:
        chunks -= 1
    size = S // chunks
    head32 = head.to(torch.float32)
    nll = z = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(chunks):
        sl = slice(c * size, (c + 1) * size)
        a, b = torch.utils.checkpoint.checkpoint(
            _chunk_terms, x[:, sl], head32, targets[:, sl],
            use_reentrant=False)
        nll, z = nll + a, z + b
    n = B * S
    return nll / n + z_loss * z / n


def param_count(params: LMParams) -> int:
    """Parameters of this rank (an EP rank holds its own experts)."""
    return sum(p.numel() for p in params.parameters())


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

