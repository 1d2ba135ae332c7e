"""Glue: bind a model to the ServingEngine callbacks.

Mirrors ``repro.serving.adapter.make_engine_fns``.  Caches are a list with
one entry per layer, a KVCache (GQA's per-head k/v or MLA's latent and
rope key) or an SSMState; every field of each carries the batch on axis 0,
so stacking concatenates each layer's fields along it into the layer's own
type and unstacking slices them back.  Model calls run under
``torch.inference_mode`` on the parameters' device and, as in the
reference, pass no router bias: a ``use_bias`` router (DeepSeek-V3) selects
on its plain scores.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import (
    LMParams,
    decode_step,
    init_caches,
    prefill_step,
)
from repro_torch.models.transformer import ParallelCtx, RuntimeConfig

__all__ = ["make_engine_fns"]


def make_engine_fns(params: LMParams, cfg: ModelConfig, rcfg: RuntimeConfig,
                    pctx: ParallelCtx, *, max_seq: int):
    """Returns (prefill_fn, decode_fn, new_cache_fn, stack_caches,
    unstack_caches)."""
    device = params.embedding.device

    @torch.inference_mode()
    def prefill_fn(tokens, caches, start, valid_len):
        return prefill_step(params, caches, tokens.to(device), cfg, rcfg,
                            pctx, valid_len=valid_len)

    @torch.inference_mode()
    def decode_fn(tokens, caches):
        return decode_step(params, caches, tokens.to(device), cfg, rcfg, pctx)

    def new_cache_fn(batch):
        return init_caches(cfg, batch, max_seq, rcfg, device=device)

    def stack_caches(caches_list):
        return [type(layer[0])(*(torch.cat(parts, dim=0)
                                 for parts in zip(*layer)))
                for layer in zip(*caches_list)]

    def unstack_caches(caches, n):
        return [[type(layer)(*(t[b:b + 1] for t in layer))
                 for layer in caches] for b in range(n)]

    return prefill_fn, decode_fn, new_cache_fn, stack_caches, unstack_caches
