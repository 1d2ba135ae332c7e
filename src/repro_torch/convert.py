"""Carry JAX parameters across to the port.

Takes the JAX package's parameter containers with numpy (or array-like)
leaves -- for instance ``jax.tree.map(np.asarray, params)`` -- and builds
the port's modules holding the same values, so both packages compute the
same function.  The containers are read by field name only; nothing of the
JAX package is imported.

* :func:`moe_params`: a ``repro.moe.layer.MoEParams``.
* :func:`ssm_params`: a ``repro.models.ssm.SSMParams``.
* :func:`mla_params`: a ``repro.models.attention.MLAParams``.
* :func:`lm_params`: a ``repro.models.model.LMParams`` of GQA or MLA
  attention and Mamba blocks, with a frontend stub's ``frontend_proj``.
  Segments built with ``scan_layers=True``
  carry a leading layer axis and are unstacked per layer, unscanned
  segments are tuples of blocks, and a hybrid's "cycle" segment is a tuple
  of ``p`` blocks each stacked over the ``n_rep`` repetitions of the
  period: layer ``pre + r * p + j`` is entry ``j`` at index ``r``.

:func:`moe_params` on an EP group of ``ep_size`` ranks gives rank
``ep_rank`` the experts ``[ep_rank * E / ep_size, (ep_rank + 1) * E /
ep_size)`` and everything else whole (the router and the shared expert
included).  Given a ``pctx`` of more than one rank (the reference's
layout, ``repro_torch.parallel.sharding``), :func:`lm_params` cuts every
parameter to this rank's shard of it on that mesh, a layer at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, layer_kinds
from repro_torch.models.attention import GQAParams, MLAParams
from repro_torch.models.model import LMParams
from repro_torch.models.ssm import SSMParams
from repro_torch.models.transformer import BlockParams
from repro_torch.moe.layer import MoEParams
from repro_torch.parallel import sharding

__all__ = ["to_tensor", "moe_params", "ssm_params", "mla_params",
           "lm_params"]


def to_tensor(a, device="cuda") -> torch.Tensor | None:
    """numpy-like array (or None) -> torch tensor on ``device``."""
    if a is None:
        return None
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _index(tree, i):
    """Leaf ``i`` of every array in a (named) tuple tree."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        vals = [_index(v, i) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return np.asarray(tree)[i]


def _rank_experts(w, ep_rank: int, ep_size: int):
    """Rows ``[ep_rank * E / ep_size, (ep_rank + 1) * E / ep_size)``."""
    E = np.shape(w)[0]
    if E % ep_size != 0 or not 0 <= ep_rank < ep_size:
        raise ValueError(f"{E} experts over rank {ep_rank} of {ep_size}")
    epr = E // ep_size
    return np.asarray(w)[ep_rank * epr:(ep_rank + 1) * epr]


def moe_params(p, *, n_slot: int, device="cuda", ep_rank: int = 0,
               ep_size: int = 1) -> MoEParams:
    t = lambda a: to_tensor(a, device)  # noqa: E731
    w1, w3, w2 = (_rank_experts(w, ep_rank, ep_size)
                  for w in (p.w1, p.w3, p.w2))
    return MoEParams(t(p.router), t(w1), t(w3), t(w2),
                     t(p.shared_w1), t(p.shared_w3), t(p.shared_w2),
                     n_slot=n_slot)


def ssm_params(p, *, device="cuda") -> SSMParams:
    t = lambda a: to_tensor(a, device)  # noqa: E731
    return SSMParams(t(p.in_proj), t(p.conv_w), t(p.conv_b), t(p.a_log),
                     t(p.d_skip), t(p.dt_bias), t(p.norm), t(p.out_proj))


def mla_params(p, *, device="cuda") -> MLAParams:
    t = lambda a: to_tensor(a, device)  # noqa: E731
    return MLAParams(t(p.wq_a), t(p.q_a_norm), t(p.wq_b), t(p.wkv_a),
                     t(p.kv_a_norm), t(p.wkv_b), t(p.wo))


def _block(bp, cfg: ModelConfig, device, ep_rank: int,
           ep_size: int) -> BlockParams:
    t = lambda a: to_tensor(a, device)  # noqa: E731
    attn = ssm = None
    if bp.ssm is not None:
        ssm = ssm_params(bp.ssm, device=device)
    elif cfg.is_mla:
        attn = mla_params(bp.attn, device=device)
    else:
        a = bp.attn
        attn = GQAParams(t(a.wq), t(a.wk), t(a.wv), t(a.wo), t(a.bq),
                         t(a.bk), t(a.bv), t(a.q_norm), t(a.k_norm))
    ffn = None if bp.ffn is None else tuple(t(w) for w in bp.ffn)
    moe = None if bp.moe is None else moe_params(
        bp.moe, n_slot=cfg.moe.n_slot, device=device, ep_rank=ep_rank,
        ep_size=ep_size)
    return BlockParams(t(bp.norm1), t(bp.norm2), attn, ffn=ffn, moe=moe,
                       ssm=ssm)


def lm_params(p, cfg: ModelConfig, *, device="cuda",
              pctx=None) -> LMParams:
    """JAX ``LMParams`` (numpy leaves) -> the port's :class:`LMParams`,
    whole, or with a ``pctx`` of more than one rank the share of its rank
    on its mesh."""
    layout, ep_rank, ep_size = None, 0, 1
    if pctx is not None and pctx.world_size > 1:
        ep_rank, ep_size = pctx.ep_rank, pctx.ep_size
        layout = sharding.lm_layout(cfg, pctx)
    blocks = []
    for seg in p.segments:
        if isinstance(seg, tuple) and not hasattr(seg, "_fields"):
            if all(np.ndim(b.norm1) == 1 for b in seg):
                blocks.extend(seg)                    # unscanned segment
                continue
            n_rep = np.shape(seg[0].norm1)[0]         # cycle segment
            blocks.extend(_index(entry, r) for r in range(n_rep)
                          for entry in seg)
        else:
            blocks.extend(_index(seg, i)              # stacked (L, ...) leaves
                          for i in range(np.shape(seg.norm1)[0]))
    if len(blocks) != len(layer_kinds(cfg)):
        raise ValueError(f"{len(blocks)} blocks for {cfg.num_layers} layers")
    layers = []
    for i, b in enumerate(blocks):
        bp = _block(b, cfg, device, ep_rank, ep_size)
        if layout is not None:
            sharding.shard_params_(bp, layout, pctx, f"layers.{i}.")
        layers.append(bp)

    def whole(name, a):
        t = to_tensor(a, device)
        if t is None or layout is None:
            return t
        return sharding.cut(t, sharding.dims_of(layout[name], pctx)).clone()

    return LMParams(embedding=whole("embedding", p.embedding),
                    layers=layers,
                    final_norm=to_tensor(p.final_norm, device),
                    lm_head=whole("lm_head", p.lm_head),
                    frontend_proj=whole("frontend_proj", p.frontend_proj),
                    layout=layout)
