"""Attention: GQA (optional QKV bias / qk-norm) and DeepSeek MLA, with
chunked prefill and a static-shape decode cache.

Mirrors ``repro.models.attention``.  Where the reference calls
``flash_ref``, the port calls ``flash_attention`` with the same arguments
(``q_offset``, ``kv_valid_len``, ``scale``): the hand-written flash kernel
on a CUDA tensor, its plain version on a CPU tensor.  ``flash_ref`` (the
online-softmax reference over KV blocks in plain tensor ops) is that plain
version, re-exported from ``repro_torch.kernels.flash_attention``;
``block_kv`` is read by it only.  The prefill/decode functions write the
cache at each row's own offset.

MLA keeps the latent cache: ``k`` holds the normalised latent c_kv
(B, S, kv_lora) and ``v`` the rotated rope key (B, S, rope).  Prefill
expands the whole latent cache to per-head K (nope + rope wide) and V (v
wide), as the reference does, and attends with the flash kernel at those
unequal head dims; decode is the absorbed form (W_UK folded into q, W_UV
applied to the latent context) in fp32 products, which the reference
computes outside any Pallas kernel too.

The full-sequence functions (``gqa_attention``, ``mla_attention``) are
differentiable: with a gradient required, ``flash_attention`` is its
autograd Function (on the card the backward kernels in fp32, the
trainer's default, and bf16 at every head-dim pair the forward takes:
GQA at the models' 128, 80 and 64, the reduced configurations' 16, and
MLA's (192, 128), DeepSeek-V3's full-sequence training path; only the
reduced MLA widths and the ``tiny`` configurations' head dim 8 raise
there).  ``plain_backward`` runs that backward as autograd through the
plain version instead.
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
from repro_torch.parallel import sharding

__all__ = ["AttnConfig", "GQAParams", "MLAParams", "KVCache", "flash_ref",
           "init_gqa", "init_mla", "gqa_attention", "mla_attention",
           "gqa_prefill", "mla_prefill", "gqa_decode", "mla_decode",
           "tp_view", "kv_heads_of", "combine_partials",
           "gqa_decode_sharded", "gqa_prefill_sharded", "mla_decode_sharded",
           "mla_prefill_sharded"]


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
    # MLA (DeepSeek-V3) dims; attention is MLA iff kv_lora_rank > 0.
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0


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
                decode: bool = False, valid_len=None, block_kv: int = 512,
                plain_backward: bool = False):
        if decode:
            return gqa_decode(x, cache, self, cfg, block_kv=block_kv)
        if cache is not None:
            return gqa_prefill(x, cache, self, cfg, valid_len=valid_len,
                               block_kv=block_kv)
        return gqa_attention(x, self, cfg, block_kv=block_kv,
                             plain_backward=plain_backward)


class MLAParams(nn.Module):
    """wq_a (D, q_lora), q_a_norm (q_lora,), wq_b (q_lora, H*(nope+rope)),
    wkv_a (D, kv_lora + rope), kv_a_norm (kv_lora,), wkv_b
    (kv_lora, H*(nope+v)), wo (H*v, D) (mirrors
    ``repro.models.attention.MLAParams``)."""

    def __init__(self, wq_a, q_a_norm, wq_b, wkv_a, kv_a_norm, wkv_b, wo):
        super().__init__()
        for name, t in (("wq_a", wq_a), ("q_a_norm", q_a_norm),
                        ("wq_b", wq_b), ("wkv_a", wkv_a),
                        ("kv_a_norm", kv_a_norm), ("wkv_b", wkv_b),
                        ("wo", wo)):
            setattr(self, name, nn.Parameter(t, requires_grad=False))

    def forward(self, x: torch.Tensor, cfg: AttnConfig, *, cache=None,
                decode: bool = False, valid_len=None, block_kv: int = 512,
                plain_backward: bool = False):
        if decode:
            return mla_decode(x, cache, self, cfg)
        if cache is not None:
            return mla_prefill(x, cache, self, cfg, valid_len=valid_len,
                               block_kv=block_kv)
        return mla_attention(x, self, cfg, block_kv=block_kv,
                             plain_backward=plain_backward)


class KVCache(NamedTuple):
    """Decode-time cache, length (B,) filled positions.  GQA: k/v
    (B, S, Hkv, hd).  MLA: k the latent (B, S, kv_lora), v the rope key
    (B, S, rope)."""

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


def init_mla(cfg: AttnConfig, generator: torch.Generator, *,
             dtype=torch.float32, device="cuda") -> MLAParams:
    D, H = cfg.d_model, cfg.num_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device) * scale

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    s = D ** -0.5
    return MLAParams(
        wq_a=normal((D, cfg.q_lora_rank), s), q_a_norm=ones(cfg.q_lora_rank),
        wq_b=normal((cfg.q_lora_rank, H * qk), cfg.q_lora_rank ** -0.5),
        wkv_a=normal((D, cfg.kv_lora_rank + cfg.qk_rope_dim), s),
        kv_a_norm=ones(cfg.kv_lora_rank),
        wkv_b=normal((cfg.kv_lora_rank,
                      H * (cfg.qk_nope_dim + cfg.v_head_dim)),
                     cfg.kv_lora_rank ** -0.5),
        wo=normal((H * cfg.v_head_dim, D), (H * cfg.v_head_dim) ** -0.5))


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
                  block_kv: int = 512,
                  plain_backward: bool = False,
                  project: bool = True) -> torch.Tensor:
    """Full-sequence GQA.  x: (B, S, D).  ``project`` False: the heads'
    output (B, S, H hd) before wo."""
    B, S, _ = x.shape
    q, k, v = _project_gqa(x, params, cfg)
    pos = torch.arange(S, device=x.device) if positions is None else positions
    cos, sin = rotary_cos_sin(pos, cfg.head_dim, cfg.rope_theta)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    out = flash_attention(q, k, v, causal=cfg.causal, block_kv=block_kv,
                          plain_backward=plain_backward)
    out = out.reshape(B, S, -1)
    return out @ params.wo if project else out


def gqa_prefill(x: torch.Tensor, cache: KVCache, params: GQAParams,
                cfg: AttnConfig, *, valid_len=None, block_kv: int = 1024,
                project: bool = True) -> tuple[torch.Tensor, KVCache]:
    """Chunked prefill: attend a chunk against cache + itself, write cache.

    x: (B, C, D) starting at absolute position cache.length; ``valid_len``
    counts the chunk's real tokens (the rest is right padding); ``project``
    as :func:`gqa_attention`'s.
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
    y = out.reshape(B, C, -1)
    y = y @ params.wo if project else y
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


def _project_mla(x: torch.Tensor, params: MLAParams, cfg: AttnConfig,
                 pos: torch.Tensor):
    """Per-head q (nope + rope, rope part rotated), the normalised latent
    c_kv and the rotated rope key k_r (B, S, rope)."""
    B, S, _ = x.shape
    H = cfg.num_heads
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    q = rms_norm(x @ params.wq_a, params.q_a_norm) @ params.wq_b
    q = q.reshape(B, S, H, nope + rope)
    kv = x @ params.wkv_a                                   # (B, S, lora+rope)
    c_kv = rms_norm(kv[..., :cfg.kv_lora_rank], params.kv_a_norm)
    k_r = kv[..., cfg.kv_lora_rank:].reshape(B, S, 1, rope)
    cos, sin = rotary_cos_sin(pos, rope, cfg.rope_theta)
    q_r = apply_rotary(q[..., nope:], cos, sin)
    k_r = apply_rotary(k_r, cos, sin)
    q = torch.cat([q[..., :nope], q_r], dim=-1)
    return q, c_kv, k_r[:, :, 0, :]


def _expand_latent(c_all: torch.Tensor, kr_all: torch.Tensor,
                   params: MLAParams, cfg: AttnConfig):
    """Per-head K (B, S, H, nope + rope), the rope key shared by every
    head, and V (B, S, H, v), a view of the expanded latent."""
    B, S, _ = c_all.shape
    H, nope, rope = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    kv = (c_all @ params.wkv_b).reshape(B, S, H, nope + cfg.v_head_dim)
    k = torch.cat([kv[..., :nope],
                   kr_all[:, :, None, :].expand(B, S, H, rope)], dim=-1)
    return k, kv[..., nope:]


def mla_attention(x: torch.Tensor, params: MLAParams, cfg: AttnConfig, *,
                  block_kv: int = 512,
                  plain_backward: bool = False,
                  project: bool = True) -> torch.Tensor:
    """Full-sequence MLA: the latent expanded to per-head K/V.
    x: (B, S, D); ``project`` as :func:`gqa_attention`'s."""
    B, S, _ = x.shape
    q, c_kv, k_r = _project_mla(x, params, cfg,
                                torch.arange(S, device=x.device))
    k, v = _expand_latent(c_kv, k_r, params, cfg)
    out = flash_attention(q, k, v, causal=cfg.causal, block_kv=block_kv,
                          scale=(cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5,
                          plain_backward=plain_backward)
    out = out.reshape(B, S, -1)
    return out @ params.wo if project else out


def mla_prefill(x: torch.Tensor, cache: KVCache, params: MLAParams,
                cfg: AttnConfig, *, valid_len=None, block_kv: int = 1024,
                project: bool = True) -> tuple[torch.Tensor, KVCache]:
    """Chunked MLA prefill on the latent cache.  x: (B, C, D) starting at
    absolute position cache.length; ``project`` as
    :func:`gqa_attention`'s."""
    B, C, _ = x.shape
    pos = cache.length[:, None] + torch.arange(C, device=x.device)[None, :]
    q, c_new, kr_new = _project_mla(x, params, cfg, pos)
    c_all = _update_at(cache.k, c_new, cache.length)
    kr_all = _update_at(cache.v, kr_new, cache.length)
    k_full, v_full = _expand_latent(c_all, kr_all, params, cfg)
    vl = C if valid_len is None else valid_len
    out = flash_attention(q, k_full, v_full, causal=True, block_kv=block_kv,
                          q_offset=cache.length,
                          kv_valid_len=cache.length + vl,
                          scale=(cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5)
    y = out.reshape(B, C, -1)
    y = y @ params.wo if project else y
    return y, KVCache(c_all, kr_all, cache.length + vl)


def mla_decode(x: torch.Tensor, cache: KVCache, params: MLAParams,
               cfg: AttnConfig) -> tuple[torch.Tensor, KVCache]:
    """Absorbed-weight MLA decode on the latent cache.  x: (B, 1, D).

    Scores s_t = q_nope^T W_UK c_t + q_rope^T k_rope_t, without expanding
    per-head K/V; the context stays latent until W_UV.  fp32 products, as
    in the reference.
    """
    B = x.shape[0]
    H = cfg.num_heads
    nope, rope, hv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    lora = cfg.kv_lora_rank
    q, c_new, kr_new = _project_mla(x, params, cfg, cache.length[:, None])
    c_all = _update_at(cache.k, c_new, cache.length)
    kr_all = _update_at(cache.v, kr_new, cache.length)
    w_full = params.wkv_b.reshape(lora, H, nope + hv).to(torch.float32)
    c32 = c_all.to(torch.float32)
    # Absorb W_UK into q: (B, 1, H, nope) x (lora, H, nope) -> (B, H, lora).
    q_abs = torch.einsum("bqhn,lhn->bhl", q[..., :nope].to(torch.float32),
                         w_full[..., :nope])
    scores = torch.einsum("bhl,bsl->bhs", q_abs, c32)
    scores = scores + torch.einsum("bqhr,bsr->bhs",
                                   q[..., nope:].to(torch.float32),
                                   kr_all.to(torch.float32))
    scores = scores * (nope + rope) ** -0.5
    S = c_all.shape[1]
    mask = (torch.arange(S, device=x.device)[None, None, :]
            <= cache.length[:, None, None])
    scores = torch.where(mask, scores, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhs,bsl->bhl", p, c32)              # latent context
    out = torch.einsum("bhl,lhv->bhv", ctx, w_full[..., nope:])
    y = out.reshape(B, 1, H * hv).to(x.dtype) @ params.wo
    return y, KVCache(c_all, kr_all, cache.length + 1)


def combine_partials(outs: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """Attention over a sequence split into T position shards, from each
    shard's partial: ``outs`` (T, B, Sq, H, hv), the attention of every
    query row over that shard's keys alone, and ``lses`` (T, B, H, Sq)
    fp32, their logsumexps (+inf: no valid key in the shard, weight 0).
    In fp32: o = sum_t exp(lse_t - M) o_t / sum_t exp(lse_t - M), M the
    largest finite lse_t; 0 for a row with no key in any shard, as the
    plain flash gives it.  The same function on the card and the CPU."""
    lse = lses.to(torch.float32).movedim(-1, -2)[..., None]   # (T,B,Sq,H,1)
    lse = torch.where(torch.isinf(lse), float("-inf"), lse)
    M = lse.amax(dim=0)
    w = torch.exp(lse - torch.where(M == float("-inf"), 0.0, M))
    den = w.sum(dim=0)
    num = (w * outs.to(torch.float32)).sum(dim=0)
    return num / den.clamp(min=1e-30)


# ------------------------------------ the sequence-sharded decode cache ----
#
# On a mesh the cache holds the rank's contiguous block of max_seq / T
# positions with every KV head (GQA), or the whole latent and rope key
# (MLA): the reference's ``cache_specs``.  A decode step is flash-decode
# over the model axis, as GSPMD partitions the reference's: every rank
# attends all query heads against its own positions (the queries, a few KB,
# gathered over the heads), and the ranks that own each head combine the
# shards' (output, logsumexp) partials (:func:`combine_partials`).  A
# prefill chunk rebuilds the rank's heads' K/V over every position from the
# shards (an all-to-all; MLA gathers its latent, 576 values a position at
# DeepSeek-V3's width), attends as on one rank, and each rank keeps the
# chunk's positions that fall in its block.  No rank keeps more than its
# shard after a call.


def _rank_kv_heads(cfg: AttnConfig, T: int, t: int) -> list:
    """The KV heads rank ``t`` of ``T`` attends with where the query heads
    split over the model axis (``tp_view``): its contiguous block of
    Hkv / T, else those its query heads read (a range, or one a query
    head)."""
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    if Hkv % T == 0:
        n = Hkv // T
        return list(range(t * n, (t + 1) * n))
    heads = kv_heads_of(H, Hkv, T, t)
    if heads is not None:
        return list(range(*heads))
    Hl, G = H // T, H // Hkv
    return [(t * Hl + j) // G for j in range(Hl)]


def _whole_kv(k: torch.Tensor, cfg: AttnConfig, pctx, split: bool):
    """(B, C, Hkv, hd) of every KV head from each rank's (B, C, Hkv_l, hd)
    of its own (an all-gather over the heads; no gradient); ``k`` itself
    where every rank computed them all."""
    from repro_torch.parallel import collectives

    T = pctx.ep_size
    if not split or T == 1:
        return k
    parts = collectives.all_gather(pctx.group, k.contiguous())
    if cfg.num_kv_heads % T == 0:
        return parts.movedim(0, 2).flatten(2, 3)
    first = {}
    for t in range(T):
        for j, h in enumerate(_rank_kv_heads(cfg, T, t)):
            first.setdefault(h, (t, j))
    return torch.stack([parts[first[h][0], :, :, first[h][1]]
                        for h in range(cfg.num_kv_heads)], dim=2)


def _heads_from_shards(shard: torch.Tensor, cfg: AttnConfig, pctx,
                       split: bool) -> torch.Tensor:
    """(B, S, Hkv_l, hd): this rank's heads (every head where the mixer
    runs whole) over every position, from each rank's position shard
    (B, S / T, Hkv, hd): an all-to-all over the model axis, each rank
    sending every other its heads' columns of its positions."""
    from repro_torch.parallel import collectives

    T = pctx.ep_size
    if T == 1:
        return shard
    if not split:
        return collectives.gather_along(pctx.group, shard, 1)
    buf = torch.stack([shard[:, :, _rank_kv_heads(cfg, T, t)]
                       for t in range(T)])
    got = collectives.all_to_all(pctx.group, buf)     # (T, B, S/T, Hl, hd)
    return got.movedim(0, 1).flatten(1, 2)


def _write_shard(shard: torch.Tensor, new: torch.Tensor,
                 length: torch.Tensor, pctx) -> torch.Tensor:
    """``shard`` (B, S / T, ...), this rank's positions of a cache of S,
    with the positions of ``new`` (B, C, ...) written at each row's
    ``length`` that fall in it: the clamped update of :func:`_update_at`
    on the whole cache (``lax.dynamic_update_slice``), cut to the shard."""
    B, Sl = shard.shape[:2]
    C = new.shape[1]
    start = length.to(torch.int64).clamp(0, Sl * pctx.ep_size - C)
    pos = torch.arange(Sl, device=shard.device) + pctx.ep_rank * Sl
    c = pos[None, :] - start[:, None]                         # (B, S/T)
    hit = ((c >= 0) & (c < C)).view(B, Sl, *[1] * (new.dim() - 2))
    idx = c.clamp(0, C - 1).view(B, Sl, *[1] * (new.dim() - 2))
    picked = torch.gather(new.to(shard.dtype), 1,
                          idx.expand(B, Sl, *new.shape[2:]))
    return torch.where(hit, picked, shard)


def _exchange_partials(out: torch.Tensor, lse: torch.Tensor, pctx,
                       split: bool):
    """Every rank's partial for this rank's heads: ``out`` (B, Sq, H, hv)
    and ``lse`` (B, H, Sq) of all H heads over this rank's positions ->
    (T, B, Sq, H_l, hv) and (T, B, H_l, Sq), source-major; an all-to-all
    over the model axis (each rank keeps its heads' partials from every
    other), or an all-gather where every rank runs every head."""
    from repro_torch.parallel import collectives

    T = pctx.ep_size
    if T == 1:
        return out[None], lse[None]
    if not split:
        return (collectives.all_gather(pctx.group, out),
                collectives.all_gather(pctx.group, lse))
    B, Sq, H, hv = out.shape
    o = out.reshape(B, Sq, T, H // T, hv).movedim(2, 0).contiguous()
    ls = lse.reshape(B, T, H // T, Sq).movedim(1, 0).contiguous()
    return (collectives.all_to_all(pctx.group, o),
            collectives.all_to_all(pctx.group, ls))


def _local_len(length: torch.Tensor, Sl: int, pctx) -> torch.Tensor:
    """Each row's valid positions in this rank's block of ``Sl``, from its
    global valid length (the flash entry clamps it to [0, Sl])."""
    return length - pctx.ep_rank * Sl


def gqa_decode_sharded(x: torch.Tensor, cache: KVCache, w, cfg: AttnConfig,
                       lcfg: AttnConfig, pctx, split: bool, *,
                       block_kv: int = 1024):
    """:func:`gqa_decode` on a mesh (the module's notes above): ``w`` and
    ``lcfg`` are the rank's heads' (``tp_view``), ``cfg`` the whole
    model's, ``cache`` the rank's position shard.  Returns the rank's
    heads' output (B, 1, H_l hd) before wo, and the new shard."""
    from repro_torch.parallel import collectives

    B = x.shape[0]
    Sl = cache.k.shape[1]
    q, k, v = _project_gqa(x, w, lcfg)
    cos, sin = rotary_cos_sin(cache.length[:, None], cfg.head_dim,
                              cfg.rope_theta)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    k_sh = _write_shard(cache.k, _whole_kv(k, cfg, pctx, split),
                        cache.length, pctx)
    v_sh = _write_shard(cache.v, _whole_kv(v, cfg, pctx, split),
                        cache.length, pctx)
    if split:
        q = collectives.gather_along(pctx.group, q, 2)         # every head
    o, lse = flash_attention(q, k_sh, v_sh, causal=False, block_kv=block_kv,
                             kv_valid_len=_local_len(cache.length + 1, Sl,
                                                     pctx),
                             return_lse=True)
    out = combine_partials(*_exchange_partials(o, lse, pctx, split))
    return (out.to(x.dtype).reshape(B, 1, -1),
            KVCache(k_sh, v_sh, cache.length + 1))


def gqa_prefill_sharded(x: torch.Tensor, cache: KVCache, w,
                        cfg: AttnConfig, lcfg: AttnConfig, pctx,
                        split: bool, *, valid_len=None, block_kv: int = 1024):
    """:func:`gqa_prefill` on a mesh: ``x`` the whole chunk (B, C, D),
    ``cache`` the rank's position shard.  The rank's heads' K/V over every
    position come from the shards (:func:`_heads_from_shards`), the chunk
    is attended as on one rank, and the chunk's positions in this rank's
    block are written with every KV head.  Returns the rank's heads'
    output (B, C, H_l hd) before wo, and the new shard."""
    B, C, _ = x.shape
    q, k, v = _project_gqa(x, w, lcfg)
    pos = cache.length[:, None] + torch.arange(C, device=x.device)[None, :]
    cos, sin = rotary_cos_sin(pos, cfg.head_dim, cfg.rope_theta)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    k_all = _update_at(_heads_from_shards(cache.k, cfg, pctx, split), k,
                       cache.length)
    v_all = _update_at(_heads_from_shards(cache.v, cfg, pctx, split), v,
                       cache.length)
    vl = C if valid_len is None else valid_len
    out = flash_attention(q, k_all, v_all, causal=True, block_kv=block_kv,
                          q_offset=cache.length,
                          kv_valid_len=cache.length + vl)
    k_sh = _write_shard(cache.k, _whole_kv(k, cfg, pctx, split),
                        cache.length, pctx)
    v_sh = _write_shard(cache.v, _whole_kv(v, cfg, pctx, split),
                        cache.length, pctx)
    return out.reshape(B, C, -1), KVCache(k_sh, v_sh, cache.length + vl)


def mla_prefill_sharded(x: torch.Tensor, cache: KVCache, w,
                        cfg: AttnConfig, lcfg: AttnConfig, pctx,
                        split: bool, *, valid_len=None, block_kv: int = 1024):
    """:func:`mla_prefill` on a mesh: the latent and rope key gathered
    over the model axis (every rank computes the chunk's own), the chunk
    attended with the rank's heads (``lcfg``), and this rank's positions
    of the new latent kept.  Returns the rank's heads' output before wo
    and the new shard."""
    from repro_torch.parallel import collectives

    del cfg, split
    g = pctx.group
    whole = KVCache(collectives.gather_along(g, cache.k, 1),
                    collectives.gather_along(g, cache.v, 1), cache.length)
    y, new = mla_prefill(x, whole, w, lcfg, valid_len=valid_len,
                         block_kv=block_kv, project=False)
    Sl = cache.k.shape[1]
    lo = pctx.ep_rank * Sl
    return y, KVCache(new.k[:, lo:lo + Sl].contiguous(),
                      new.v[:, lo:lo + Sl].contiguous(), new.length)


def mla_decode_sharded(x: torch.Tensor, cache: KVCache, w, cfg: AttnConfig,
                       lcfg: AttnConfig, pctx, split: bool):
    """:func:`mla_decode` on a mesh, absorbed, in fp32 products: each rank
    absorbs W_UK into its heads' queries, the (q_abs, q_rope) of every
    head are gathered (B x H x (kv_lora + rope) values), every rank scores
    all heads against its latent shard and forms its partial latent
    context with its logsumexp, and each head's owner combines them
    (:func:`combine_partials`) and applies its W_UV.  Returns the rank's
    heads' output (B, 1, H_l v) before wo, and the new shard."""
    from repro_torch.parallel import collectives

    B = x.shape[0]
    Hl = lcfg.num_heads
    nope, rope, hv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    lora = cfg.kv_lora_rank
    Sl = cache.k.shape[1]
    q, c_new, kr_new = _project_mla(x, w, lcfg, cache.length[:, None])
    c_sh = _write_shard(cache.k, c_new, cache.length, pctx)
    kr_sh = _write_shard(cache.v, kr_new, cache.length, pctx)
    w_full = w.wkv_b.reshape(lora, Hl, nope + hv).to(torch.float32)
    q_abs = torch.einsum("bqhn,lhn->bhl", q[..., :nope].to(torch.float32),
                         w_full[..., :nope])
    qq = torch.cat([q_abs, q[:, 0, :, nope:].to(torch.float32)], dim=-1)
    if split:
        qq = collectives.gather_along(pctx.group, qq, 1)     # every head
    c32, kr32 = c_sh.to(torch.float32), kr_sh.to(torch.float32)
    scores = (torch.einsum("bhl,bsl->bhs", qq[..., :lora], c32)
              + torch.einsum("bhr,bsr->bhs", qq[..., lora:], kr32))
    scores = scores * (nope + rope) ** -0.5
    pos = torch.arange(Sl, device=x.device) + pctx.ep_rank * Sl
    mask = pos[None, None, :] <= cache.length[:, None, None]
    scores = torch.where(mask, scores, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - torch.where(m == float("-inf"), 0.0, m))
    den = p.sum(dim=-1, keepdim=True)
    ctx = torch.einsum("bhs,bsl->bhl", p, c32) / den.clamp(min=1e-30)
    lse = torch.where(den > 0, m + torch.log(den), float("inf"))   # (B,H,1)
    ctx = combine_partials(*_exchange_partials(ctx[:, None], lse, pctx,
                                               split))[:, 0]
    out = torch.einsum("bhl,lhv->bhv", ctx, w_full[..., nope:])
    return (out.reshape(B, 1, Hl * hv).to(x.dtype),
            KVCache(c_sh, kr_sh, cache.length + 1))


def kv_heads_of(H: int, Hkv: int, T: int, t: int):
    """The KV heads the query heads ``[t H / T, (t + 1) H / T)`` read: a
    contiguous range ``(k0, k1)`` where each of its heads serves an equal
    run of them (a GQA group of the rank's own), else None (one KV head
    per query head, gathered)."""
    Hl, G = H // T, H // Hkv
    heads = [(t * Hl + j) // G for j in range(Hl)]
    k0, k1 = heads[0], heads[-1] + 1
    n = k1 - k0
    if Hl % n == 0 and all(h - k0 == j // (Hl // n)
                           for j, h in enumerate(heads)):
        return k0, k1
    return None


def _kv_cols(w: torch.Tensor, heads: list, hd: int) -> torch.Tensor:
    """Columns of a (..., Hkv * hd) tensor of the KV heads ``heads``."""
    idx = torch.tensor([h * hd + i for h in heads for i in range(hd)],
                       device=w.device)
    return w.index_select(w.dim() - 1, idx)


def tp_view(params, cfg: AttnConfig, pctx, spec: dict):
    """(weights, config, split) of this rank on a mesh:
    the tensors ``gqa_*`` / ``mla_*`` compute with, the config of the
    rank's heads, and whether the heads split over the model axis (False:
    every weight is gathered whole and the mixer runs whole on every rank,
    where the heads do not divide by the axis).  ``spec``: the mixer's
    entries (``sharding.block_layout`` without the ``attn.`` prefix)."""
    from types import SimpleNamespace

    T, t = pctx.ep_size, pctx.ep_rank
    H = cfg.num_heads
    names = [n for n in spec if getattr(params, n, None) is not None]
    split = T > 1 and H % T == 0      # then H * hd divides: wq is split
    if not split:
        return (SimpleNamespace(**{n: sharding.use(
            getattr(params, n), spec[n], pctx, model=True) for n in names}),
            cfg, False)
    Hl = H // T
    if cfg.is_mla:
        w = {n: sharding.use(getattr(params, n), spec[n], pctx,
                             model=n == "wq_a") for n in names}
        return (SimpleNamespace(**w),
                dataclasses.replace(cfg, num_heads=Hl, num_kv_heads=Hl),
                True)
    w = {n: sharding.use(getattr(params, n), spec[n], pctx)
         for n in names if n not in ("wk", "wv", "bk", "bv")}
    Hkv, hd = cfg.num_kv_heads, cfg.head_dim
    kv = [n for n in ("wk", "wv", "bk", "bv") if n in names]
    if Hkv % T == 0:
        w.update({n: sharding.use(getattr(params, n), spec[n], pctx)
                  for n in kv})
        Hkv_l = Hkv // T
    else:
        heads = _rank_kv_heads(cfg, T, t)
        Hkv_l = len(heads)
        w.update({n: _kv_cols(sharding.use(getattr(params, n), spec[n],
                                           pctx, model=True), heads, hd)
                  for n in kv})
    return (SimpleNamespace(**w),
            dataclasses.replace(cfg, num_heads=Hl, num_kv_heads=Hkv_l), True)
