"""Train step: loss, gradients, microbatched accumulation, clipping, AdamW
and the aux-free router-bias update.

Mirrors ``repro.train.loop``.  ``make_train_step`` returns ``(state, batch)
-> (state, metrics)``; where the JAX step is a pure function for ``jit``
with donated state, this one updates the parameters and the optimizer
state in place (autograd accumulates the microbatches' gradients in each
parameter's ``.grad``) and returns the same :class:`TrainState` with the
new step and router bias.  Microbatches split the batch's leading axis;
the gradient and the loss are their means, as the reference's scan
computes them.  The router bias is updated outside the gradient from the
realized per-layer loads (DeepSeek's recipe, free routing only), and the
gradients are clipped by their global norm before the optimizer.  Metrics
are device tensors: nothing here reads the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import (LMParams, blocked_lm_loss, forward,
                                      init_router_bias, lm_loss)
from repro_torch.models.transformer import (ParallelCtx, RuntimeConfig,
                                            effective_rack_limit)
from repro_torch.moe.gating import update_router_bias
from repro_torch.optim.optimizer import Optimizer, clip_by_global_norm

__all__ = ["TrainConfig", "TrainState", "init_train_state", "loss_and_grads",
           "make_train_step"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    clip_norm: float = 1.0
    bias_update: bool = True        # aux-free router bias update


class TrainState(NamedTuple):
    params: LMParams
    opt_state: Any
    router_bias: torch.Tensor | None
    step: int


def init_train_state(params: LMParams, optimizer: Optimizer,
                     cfg: ModelConfig) -> TrainState:
    """Make every parameter trainable and start the optimizer state."""
    params.requires_grad_(True)
    plist = list(params.parameters())
    return TrainState(params=params, opt_state=optimizer.init(plist),
                      router_bias=init_router_bias(
                          cfg, device=plist[0].device),
                      step=0)


def _loss(params, batch, cfg, rcfg, pctx, router_bias):
    if rcfg.loss_chunks > 1:
        x, aux, drops, counts = forward(params, batch, cfg, rcfg, pctx,
                                        router_bias=router_bias,
                                        return_hidden=True)
        loss = blocked_lm_loss(x, params.head(), batch["targets"],
                               chunks=rcfg.loss_chunks) + aux
    else:
        logits, aux, drops, counts = forward(params, batch, cfg, rcfg, pctx,
                                             router_bias=router_bias)
        loss = lm_loss(logits, batch["targets"]) + aux
    return loss, drops, counts


def loss_and_grads(params: LMParams, batch: dict, cfg: ModelConfig,
                   rcfg: RuntimeConfig, pctx: ParallelCtx,
                   tcfg: TrainConfig = TrainConfig(),
                   router_bias: torch.Tensor | None = None):
    """(loss, drops, counts, grads): the mean over ``tcfg.microbatches`` of
    the loss and of each parameter's gradient (``grads`` in
    ``params.parameters()`` order, the parameters' ``.grad``), the summed
    drops and per-layer expert counts."""
    plist = list(params.parameters())
    for p in plist:
        p.grad = None
    n = max(1, tcfg.microbatches)
    B = batch["tokens"].shape[0]
    if B % n:
        raise ValueError(f"batch {B} does not split into {n} microbatches")
    loss = drops = counts = None
    for i in range(n):
        mb = {k: v[i * (B // n):(i + 1) * (B // n)] for k, v in batch.items()}
        li, di, ci = _loss(params, mb, cfg, rcfg, pctx, router_bias)
        li.backward()
        li = li.detach()
        loss = li if loss is None else loss + li
        drops = di if drops is None else drops + di
        counts = ci if counts is None else counts + ci
    grads = []
    for p in plist:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    if n > 1:
        with torch.no_grad():
            for g in grads:
                g.mul_(1.0 / n)
        loss = loss * (1.0 / n)
    return loss, drops, counts, grads


def make_train_step(cfg: ModelConfig, rcfg: RuntimeConfig, pctx: ParallelCtx,
                    optimizer: Optimizer, tcfg: TrainConfig = TrainConfig()):
    def train_step(state: TrainState, batch: dict):
        params = state.params
        loss, drops, counts, grads = loss_and_grads(
            params, batch, cfg, rcfg, pctx, tcfg, state.router_bias)
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, tcfg.clip_norm)
            opt_state = optimizer.update(grads, state.opt_state,
                                         list(params.parameters()),
                                         state.step)
        for p in params.parameters():
            p.grad = None
        router_bias = state.router_bias
        if router_bias is not None and tcfg.bias_update and \
                cfg.moe is not None:
            # Only the MoE layers' rows move (a dense layer counts nothing).
            # Where the gate's rack limit binds, the two-level per-rack
            # update (DESIGN.md S14).
            limit = effective_rack_limit(cfg.moe, rcfg, pctx.racks)
            is_moe = counts.sum(dim=1) > 0
            upd = update_router_bias(
                router_bias, counts, cfg.moe.bias_update_speed,
                num_racks=pctx.racks if 0 < limit < pctx.racks else 1)
            router_bias = torch.where(is_moe[:, None], upd, router_bias)
        metrics = {"loss": loss, "grad_norm": gnorm, "drops": drops,
                   "counts": counts, "step": state.step}
        return TrainState(params, opt_state, router_bias,
                          state.step + 1), metrics

    return train_step
