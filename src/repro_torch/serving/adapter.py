"""Glue: bind a model to the ServingEngine callbacks.

Mirrors ``repro.serving.adapter.make_engine_fns``.  Caches are a list with
one entry per layer, a KVCache (GQA's per-head k/v or MLA's latent and
rope key) or an SSMState; every field of each carries the batch on axis 0,
so stacking concatenates each layer's fields along it into the layer's own
type and unstacking slices them back.  Model calls run under
``torch.inference_mode`` on the parameters' device and, as in the
reference, pass no router bias: a ``use_bias`` router (DeepSeek-V3) selects
on its plain scores.

On a mesh (``pctx`` of more than one rank) the caches are the rank's
shards (``sharding.cache_specs``), a prefill chunk is cut to the rank's
shard of its sequence (whole on every rank where the chunk does not
divide by the model axis, ``ParallelCtx.seq_whole``), and the
column-parallel logits are gathered (``model.gather_logits``), so the
engine sees what one rank gives it.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import (
    LMParams,
    decode_step,
    gather_logits,
    init_caches,
    prefill_step,
)
from repro_torch.models.transformer import ParallelCtx, RuntimeConfig
from repro_torch.parallel import sharding

__all__ = ["make_engine_fns"]


def make_engine_fns(params: LMParams, cfg: ModelConfig, rcfg: RuntimeConfig,
                    pctx: ParallelCtx, *, max_seq: int):
    """Returns (prefill_fn, decode_fn, new_cache_fn, stack_caches,
    unstack_caches)."""
    device = params.embedding.device
    T, V = pctx.ep_size, cfg.vocab_size

    @torch.inference_mode()
    def prefill_fn(tokens, caches, start, valid_len):
        ctx, tokens = pctx, tokens.to(device)
        if sharding.stream_whole(pctx, tokens.shape[1]):
            ctx = dataclasses.replace(pctx, seq_whole=True)
        elif T > 1:
            n = tokens.shape[1] // T
            tokens = tokens[:, pctx.ep_rank * n:(pctx.ep_rank + 1) * n]
        logits, caches = prefill_step(params, caches, tokens, cfg, rcfg,
                                      ctx, valid_len=valid_len)
        return gather_logits(logits, ctx, V), caches

    whole = dataclasses.replace(pctx, seq_whole=True)

    @torch.inference_mode()
    def decode_fn(tokens, caches):
        logits, caches = decode_step(params, caches, tokens.to(device), cfg,
                                     rcfg, pctx)
        return gather_logits(logits, whole, V), caches

    def new_cache_fn(batch):
        return init_caches(cfg, batch, max_seq, rcfg, device=device,
                           pctx=pctx)

    def stack_caches(caches_list):
        return [type(layer[0])(*(torch.cat(parts, dim=0)
                                 for parts in zip(*layer)))
                for layer in zip(*caches_list)]

    def unstack_caches(caches, n):
        return [[type(layer)(*(t[b:b + 1] for t in layer))
                 for layer in caches] for b in range(n)]

    return prefill_fn, decode_fn, new_cache_fn, stack_caches, unstack_caches
