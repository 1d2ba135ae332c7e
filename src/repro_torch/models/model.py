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

On a mesh (a ``ParallelCtx`` of more than one rank: the reference's
layout, ``repro_torch.parallel.sharding``) every parameter is this rank's
shard (``LMParams.layout`` holds the entries it was cut by), the batch is
this rank's share (rows over the data axis, the sequence over the model
axis where it divides: ``sharding.local_batch``) and the residual stream
between blocks its sequence shard, or the whole sequence where it does
not divide and at decode (``ParallelCtx.seq_whole``).  The embedding is
vocab-parallel over the model axis (the token ids gathered, the rank's
rows looked up with the others masked to zero, then a reduce-scatter along
the sequence, or an all-reduce onto a whole stream); the head gives logits
column-parallel over the vocabulary (B, S, V / T) of the whole sequence,
and :func:`lm_loss` and :func:`blocked_lm_loss` take the row max, the sum
of exponentials and the target's logit over the model axis, so the
vocab-sized logits are never gathered in training.  Where the vocabulary
does not divide by the model axis the table is whole on every rank: the
logits are the stream's (B, S / T, V), or (B, S, V) on a whole stream,
and the losses sum each rank's share of the tokens' terms over the model
axis.  :func:`gather_logits` puts either back together.  The decode cache
holds the rank's block of positions (``sharding.cache_specs``).
"""

from __future__ import annotations

import dataclasses

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
from repro_torch.parallel import collectives, sharding

__all__ = ["LMParams", "init_lm", "init_router_bias", "forward", "lm_loss",
           "blocked_lm_loss", "init_caches", "prefill_step", "decode_step",
           "param_count", "head_of", "vocab_split", "gather_logits"]


class LMParams(nn.Module):
    """embedding (V, D), one BlockParams per layer, final_norm (D,),
    lm_head (V, D) or None when tied, frontend_proj (D, D) for a modality
    frontend stub or None.  Built with ``requires_grad=False`` (serving);
    ``requires_grad_(True)`` makes every parameter trainable
    (``repro_torch.train.loop.init_train_state`` does)."""

    def __init__(self, embedding, layers, final_norm, lm_head=None,
                 frontend_proj=None, layout=None):
        super().__init__()
        self.layout = layout        # on a mesh: every parameter's entries
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
    last.  On a mesh each parameter is drawn whole from the one-rank
    stream and cut to this rank's shard before the next is drawn (a layer
    at a time), so the shard equals the slice of the one-rank init
    bitwise."""
    layout = sharding.lm_layout(cfg, pctx) if pctx.world_size > 1 else None
    layers = []
    for i, kind in enumerate(layer_kinds(cfg)):
        bp = init_block(cfg, kind, rcfg, pctx, generator, device=device)
        if layout is not None:
            sharding.shard_params_(bp, layout, pctx, f"layers.{i}.")
        layers.append(bp)
    D, V = cfg.d_model, cfg.vocab_size

    def normal(name, shape, std=0.02):
        t = torch.randn(shape, generator=generator, dtype=rcfg.dtype,
                        device=device) * std
        if layout is None:
            return t
        return sharding.cut(t, sharding.dims_of(layout[name], pctx)
                            ).clone()

    embedding = normal("embedding", (V, D))
    lm_head = None if cfg.tie_embeddings else normal("lm_head", (V, D))
    return LMParams(
        embedding=embedding, layers=layers,
        final_norm=torch.ones(D, dtype=rcfg.dtype, device=device),
        lm_head=lm_head,
        frontend_proj=(None if cfg.frontend == "none"
                       else normal("frontend_proj", (D, D), D ** -0.5)),
        layout=layout)


def init_router_bias(cfg: ModelConfig, *, device="cuda"
                     ) -> torch.Tensor | None:
    """(num_layers, E) aux-free routing bias (zeros for non-MoE layers)."""
    if cfg.moe is None or not cfg.moe.use_bias:
        return None
    return torch.zeros((cfg.num_layers, cfg.moe.num_experts),
                       dtype=torch.float32, device=device)


def _input_embeddings(params: LMParams, batch: dict, cfg: ModelConfig,
                      pctx: ParallelCtx) -> torch.Tensor:
    """Embed the tokens, or take the stub frontend's embeddings: frames
    (B, S, D) through ``frontend_proj``, or projected patches (B, P, D)
    over the first P token positions (mirrors the reference's
    ``_input_embeddings``).  The stub's inputs are cast to the
    projection's dtype."""
    proj = params.frontend_proj
    lay = params.layout
    if proj is not None and lay is not None:
        proj = sharding.use(proj, lay["frontend_proj"], pctx, model=True)
    if cfg.frontend == "audio_frames":
        return batch["frames"].to(proj.dtype) @ proj
    x = _embed_tokens(params, batch["tokens"], pctx)
    if cfg.frontend == "vision_patches":
        patches = batch["patches"].to(proj.dtype) @ proj          # (B, P, D)
        P, Sl = patches.shape[1], x.shape[1]
        lo = 0 if lay is None or pctx.seq_whole else pctx.ep_rank * Sl
        n = min(max(P - lo, 0), Sl)
        x = torch.cat([patches[:, lo:lo + n].to(x.dtype), x[:, n:]], dim=1)
    return x


def _embed_tokens(params: LMParams, tokens: torch.Tensor,
                  pctx: ParallelCtx) -> torch.Tensor:
    if params.layout is None:
        return embed(tokens, params.embedding)
    return _embed_sharded(tokens, params.embedding,
                          params.layout["embedding"], pctx)


def _embed_sharded(tokens, table, spec, pctx):
    """The embedding of the stream's ``tokens`` (this rank's sequence
    shard, or the whole sequence on a whole stream) on a mesh:
    vocab-parallel (every rank's token ids gathered, its rows of the table
    looked up with the others masked to zero, a reduce-scatter along the
    sequence, or an all-reduce onto a whole stream), or a whole table's
    rows of the stream's own tokens where the vocabulary does not
    divide."""
    g, T = pctx.group, pctx.ep_size
    if T == 1 or not sharding.on_model(spec[0]):
        return embed(tokens, sharding.use(table, spec, pctx, model=True))
    tab = sharding.use(table, spec, pctx)
    ids = tokens if pctx.seq_whole else collectives.gather_along(g, tokens, 1)
    Vl = tab.shape[0]
    local = ids - pctx.ep_rank * Vl
    mine = (local >= 0) & (local < Vl)
    e = embed(local.clamp(0, Vl - 1), tab) * mine[..., None].to(tab.dtype)
    if pctx.seq_whole:
        return collectives.reduce_whole(g, e)
    return collectives.scatter_along(g, e, 1)


def head_of(params: LMParams, pctx: ParallelCtx) -> torch.Tensor:
    """The output head a rank computes with: (V, D), or on the sharded
    layout its vocab rows gathered over the data axis."""
    head = params.head()
    if params.layout is None:
        return head
    name = "embedding" if params.lm_head is None else "lm_head"
    return sharding.use(head, params.layout[name], pctx)


def _unembed(x: torch.Tensor, params: LMParams, pctx: ParallelCtx):
    """fp32 logits of the final-norm stream: (B, S, V), or on a mesh
    column-parallel (B, S, V / T) over the whole sequence (gathered from
    the shards, unless the stream is whole), or where the vocabulary does
    not divide the stream's own (B, S / T, V) (a whole stream's (B, S,
    V))."""
    head = head_of(params, pctx)
    if not vocab_split(params, pctx) or pctx.seq_whole:
        return unembed(x, head)
    return unembed(collectives.gather_along(pctx.group, x, 1), head)


def vocab_split(params, pctx) -> bool:
    """On a mesh, the head's rows split over the model axis (the
    vocabulary divides by it)."""
    return params.layout is not None and pctx.ep_size > 1 and \
        sharding.on_model(params.layout["embedding"][0])


def gather_logits(logits: torch.Tensor, pctx: ParallelCtx,
                  vocab_size: int) -> torch.Tensor:
    """The whole (B, S, V) logits from a mesh's (collective over the model
    axis, no gradient): column-parallel (B, S, V / T) are gathered along
    the vocabulary, a sequence shard's (B, S / T, V) along the sequence
    (``pctx`` the call's: a whole stream's (B, S, V) are whole already)."""
    if pctx.ep_size == 1:
        return logits
    if logits.shape[-1] != vocab_size:
        return collectives.gather_along(pctx.group, logits.detach(), 2)
    if pctx.seq_whole:
        return logits
    return collectives.gather_along(pctx.group, logits.detach(), 1)


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
    x = _input_embeddings(params, batch, cfg, pctx)
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
    return _unembed(x, params, pctx), aux_tot, drops_tot, counts


def lm_loss(logits: torch.Tensor, targets: torch.Tensor, *,
            z_loss: float = 1e-4,
            pctx: ParallelCtx | None = None,
            vocab_split: bool | None = None) -> torch.Tensor:
    """Token cross-entropy (fp32) with z-loss regularisation.  On a mesh
    ``targets`` is the stream's (the rank's sequence shard, or the whole
    sequence where ``pctx.seq_whole``) and ``logits`` the head's (see the
    module's notes; ``vocab_split``: the head's rows split over the model
    axis, which a sequence shard's shapes tell where it is None); the loss
    is the data rank's, on every rank of its model group."""
    if pctx is None or pctx.ep_size == 1:
        logits = logits.to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1,
                          targets[..., None].to(torch.int64))[..., 0]
        return (lse - ll).mean() + z_loss * (lse ** 2).mean()
    if vocab_split is None:
        if pctx.seq_whole:
            raise ValueError("lm_loss on a whole stream needs vocab_split")
        vocab_split = logits.shape[1] != targets.shape[1]
    if vocab_split:
        tg = targets if pctx.seq_whole else \
            collectives.gather_along(pctx.group, targets, 1)
        a, b = _ce_split(logits.to(torch.float32), tg, pctx)
        return a / tg.numel() + z_loss * b / tg.numel()
    logits, targets, n = _token_share(logits, targets, pctx)
    a, b = _ce_terms(logits.to(torch.float32), targets)
    ab = collectives.all_reduce(pctx.group, torch.stack([a, b]))
    return ab[0] / n + z_loss * ab[1] / n


def _token_share(x, targets, pctx):
    """(x, targets, global token count) of this rank's share of the
    tokens where the head is whole on every rank: the stream's shard as it
    is, or on a whole stream the rank's block of ``torch.tensor_split``'s
    T blocks of the sequence, so the model axis's sum of the ranks' terms
    counts each token once (and each rank back-propagates its own)."""
    B, S = targets.shape[:2]
    if not pctx.seq_whole:
        return x, targets, B * S * pctx.ep_size
    part = torch.tensor_split(torch.arange(S), pctx.ep_size)[pctx.ep_rank]
    lo, hi = (int(part[0]), int(part[-1]) + 1) if len(part) else (0, 0)
    return x[:, lo:hi], targets[:, lo:hi], B * S


def _ce_terms(logits: torch.Tensor, targets: torch.Tensor):
    """(sum of lse - target logit, sum of lse^2) over the tokens."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, targets[..., None].to(torch.int64))[..., 0]
    return (lse - ll).sum(), (lse ** 2).sum()


def _ce_split(logits, targets, pctx):
    """:func:`_ce_terms` from this model rank's column-parallel logits
    (B, S, V / T) of the whole sequence's ``targets``: the row max, the
    sum of exponentials and the target's logit taken over the model axis.
    The sums' backward is the identity: every rank holds the same loss
    and back-propagates it whole."""
    g = pctx.group
    Vl = logits.shape[-1]
    m = collectives.all_max(g, logits.detach().amax(dim=-1))
    se = collectives.all_reduce(
        g, torch.exp(logits - m[..., None]).sum(dim=-1))
    lse = m + torch.log(se)
    local = targets.to(torch.int64) - pctx.ep_rank * Vl
    mine = (local >= 0) & (local < Vl)
    ll = torch.gather(logits, -1, local.clamp(0, Vl - 1)[..., None])[..., 0]
    ll = collectives.all_reduce(g, torch.where(mine, ll, 0.0))
    return (lse - ll).sum(), (lse ** 2).sum()


def _chunk_terms(xc: torch.Tensor, head32: torch.Tensor, tc: torch.Tensor,
                 pctx=None):
    logits = torch.einsum("bsd,vd->bsv", xc.to(torch.float32), head32)
    if pctx is None:
        return _ce_terms(logits, tc)
    return _ce_split(logits, tc, pctx)


def blocked_lm_loss(x: torch.Tensor, head: torch.Tensor,
                    targets: torch.Tensor, *, z_loss: float = 1e-4,
                    chunks: int = 8, pctx: ParallelCtx | None = None,
                    vocab_split: bool = False) -> torch.Tensor:
    """Cross-entropy over sequence chunks without materialising the full
    (B, S, V) fp32 logits: each chunk's logits are recomputed in the
    backward (``torch.utils.checkpoint``, the reference's
    ``jax.checkpoint``).  The head is cast to fp32 once, so its gradient
    accumulates over the chunks in fp32.  On a mesh ``x`` is the
    final-norm stream (a shard, or whole where ``pctx.seq_whole``),
    ``head`` :func:`head_of`'s and ``targets`` the stream's: with
    ``vocab_split`` (the head's rows split over the model axis) the
    sequence is gathered (unless whole) and each chunk's column-parallel
    terms are taken over the model axis, else each rank's share of the
    tokens (:func:`_token_share`) is chunked and the terms are summed over
    it."""
    sharded = pctx is not None and pctx.ep_size > 1
    split = sharded and vocab_split
    n = targets.numel()
    if split and not pctx.seq_whole:
        x = collectives.gather_along(pctx.group, x, 1)
        targets = collectives.gather_along(pctx.group, targets, 1)
        n = targets.numel()
    elif sharded and not split:
        x, targets, n = _token_share(x, targets, pctx)
    B, S, _ = x.shape
    chunks = max(1, min(chunks, S))
    while S and S % chunks:
        chunks -= 1
    size = S // chunks
    head32 = head.to(torch.float32)
    nll = z = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(chunks if S else 0):
        sl = slice(c * size, (c + 1) * size)
        a, b = torch.utils.checkpoint.checkpoint(
            _chunk_terms, x[:, sl], head32, targets[:, sl],
            pctx if split else None, use_reentrant=False)
        nll, z = nll + a, z + b
    if sharded and not split:
        nz = collectives.all_reduce(pctx.group, torch.stack([nll, z]))
        nll, z = nz[0], nz[1]
    return nll / n + z_loss * z / n


def param_count(params: LMParams) -> int:
    """Parameters of this rank (an EP rank holds its own experts)."""
    return sum(p.numel() for p in params.parameters())


def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                rcfg: RuntimeConfig, *, device="cuda",
                pctx: ParallelCtx | None = None) -> list:
    """One decode cache per layer (KVCache or SSMState by the layer's
    kind) for ``batch`` rows of ``max_seq`` positions; on a mesh the
    rank's shard of them (``transformer.init_cache_block``)."""
    return [init_cache_block(cfg, kind, batch, max_seq, rcfg.dtype,
                             device=device, pctx=pctx)
            for kind in layer_kinds(cfg)]


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

    Returns (logits (B, C, V) fp32, new_caches).  On a mesh ``tokens`` is
    this rank's shard of the chunk (B, C / T), or the whole chunk where
    ``pctx.seq_whole`` (a C that does not divide by the model axis:
    ``sharding.stream_whole``), and the logits are column-parallel (B, C,
    V / T) (:func:`gather_logits` makes them whole).
    """
    x = _embed_tokens(params, tokens, pctx)
    x, new_caches = _run_layers(x, params, caches, cfg, rcfg, pctx,
                                decode=False, valid_len=valid_len,
                                router_bias=router_bias)
    return _unembed(x, params, pctx), new_caches


def decode_step(params: LMParams, caches, tokens: torch.Tensor,
                cfg: ModelConfig, rcfg: RuntimeConfig, pctx: ParallelCtx, *,
                router_bias: torch.Tensor | None = None):
    """One-token decode.  tokens: (B, 1) (on a mesh the data rank's rows).
    Returns (logits, new_caches); on a mesh the stream is whole and the
    logits column-parallel (B, 1, V / T) where the vocabulary divides
    (:func:`gather_logits` with ``seq_whole`` set makes them whole)."""
    if pctx.world_size > 1:
        pctx = dataclasses.replace(pctx, seq_whole=True)
    x = _embed_tokens(params, tokens, pctx)
    x, new_caches = _run_layers(x, params, caches, cfg, rcfg, pctx,
                                decode=True, router_bias=router_bias)
    return _unembed(x, params, pctx), new_caches
