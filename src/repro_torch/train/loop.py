"""Train step: loss, gradients, microbatched accumulation, clipping, the
optimizer (AdamW or Adafactor) and the aux-free router-bias update.

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

On a mesh of D data rows x R EP ranks (``ParallelCtx`` ``data`` and
``group``) the step takes the global batch and runs its rank's share
(``sharding.local_batch``: its data rank's rows, and its model rank's
shard of the sequence where the sequence divides by the model axis; the
whole sequence otherwise, ``ParallelCtx.seq_whole``).  The rule: the sum over every
rank of each rank's gradient contribution is the gradient of the
reference's one global loss, the LM loss's mean over the global batch
plus the aux loss summed over all ranks (the reference's island returns
each device's aux and sums them).  So each rank back-propagates its data
row's LM loss (the same on every rank of its model group) scaled by 1/D
plus the summed aux (whose ``all_reduce`` passes each rank's own term
back); the gradients are then summed over each parameter's ``reduce``
group (``sharding.lm_param_specs``): over the axes the parameter is not
split over (a split one's sum over the data axis is its gather's
reduce-scatter).  Taking the mean over the data group instead would
leave the aux term's gradient D times too small.  Where the global batch does not divide over the data
group, every data row runs all of it (``ParallelCtx.batch_replicated``):
the reference then sums aux, drops and counts over the EP axes only, and
each rank back-propagates its aux scaled by 1/D as well.  The metrics
are the reference's global values on every rank, the router bias moves
with the global counts, so every replica stays equal.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import (LMParams, blocked_lm_loss, forward,
                                      head_of, init_router_bias, lm_loss,
                                      vocab_split)
from repro_torch.models.transformer import (ParallelCtx, RuntimeConfig,
                                            effective_rack_limit)
from repro_torch.moe.gating import update_router_bias
from repro_torch.optim.optimizer import (Optimizer, clip_by_global_norm,
                                         reduce_grads)
from repro_torch.parallel import collectives, sharding

__all__ = ["TrainConfig", "TrainState", "init_train_state", "loss_and_grads",
           "global_grads", "make_train_step", "global_shapes",
           "state_to_global", "state_from_global"]


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
    """Make every parameter trainable and start the optimizer state: the
    moments take each parameter's shard (on a mesh they mirror the
    placements, as the reference's ``opt_state_specs``)."""
    params.requires_grad_(True)
    plist = list(params.parameters())
    return TrainState(params=params, opt_state=optimizer.init(plist),
                      router_bias=init_router_bias(
                          cfg, device=plist[0].device),
                      step=0)


def _loss(params, batch, cfg, rcfg, pctx, router_bias):
    """(LM loss, aux, drops, counts) of this rank's rows."""
    if rcfg.loss_chunks > 1:
        x, aux, drops, counts = forward(params, batch, cfg, rcfg, pctx,
                                        router_bias=router_bias,
                                        return_hidden=True)
        lm = blocked_lm_loss(x, head_of(params, pctx), batch["targets"],
                             chunks=rcfg.loss_chunks, pctx=pctx,
                             vocab_split=vocab_split(params, pctx))
    else:
        logits, aux, drops, counts = forward(params, batch, cfg, rcfg, pctx,
                                             router_bias=router_bias)
        lm = lm_loss(logits, batch["targets"], pctx=pctx,
                     vocab_split=vocab_split(params, pctx))
    return lm, aux, drops, counts


def loss_and_grads(params: LMParams, batch: dict, cfg: ModelConfig,
                   rcfg: RuntimeConfig, pctx: ParallelCtx,
                   tcfg: TrainConfig = TrainConfig(),
                   router_bias: torch.Tensor | None = None):
    """(loss, drops, counts, grads): the mean over ``tcfg.microbatches`` of
    the loss and of each parameter's gradient (``grads`` in
    ``params.parameters()`` order, the parameters' ``.grad``), the summed
    drops and per-layer expert counts.

    On a mesh ``batch`` is this data rank's rows; the loss is the global
    one and each gradient is this rank's contribution, before the sums
    over the mesh (see the module's notes)."""
    plist = list(params.parameters())
    for p in plist:
        p.grad = None
    n = max(1, tcfg.microbatches)
    D = pctx.data_size
    B = batch["targets"].shape[0]
    if B % n:
        raise ValueError(f"batch {B} does not split into {n} microbatches")
    loss = drops = counts = None
    for i in range(n):
        mb = {k: v[i * (B // n):(i + 1) * (B // n)] for k, v in batch.items()}
        lm, aux, di, ci = _loss(params, mb, cfg, rcfg, pctx, router_bias)
        if D > 1:
            lm = lm * (1.0 / D)
        # A replicated batch: every data row holds the same aux as well.
        li = lm + (aux * (1.0 / D) if pctx.batch_replicated else aux)
        li.backward()
        li = li.detach()
        if D > 1:       # the global loss: the data rows' LM terms summed
            li = collectives.all_reduce(pctx.data, lm.detach()) + aux.detach()
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


def global_grads(params: LMParams, batch: dict, cfg: ModelConfig,
                 rcfg: RuntimeConfig, pctx: ParallelCtx,
                 tcfg: TrainConfig = TrainConfig(),
                 router_bias: torch.Tensor | None = None, *,
                 global_batch: int | None = None):
    """:func:`loss_and_grads` of this rank's share of the global ``batch``
    (``sharding.local_batch``; with ``global_batch``, ``batch`` is that
    share already, of a global batch of that many rows), then each
    gradient summed over its group of the mesh
    (``sharding.lm_param_specs``): the gradients of the global loss (a
    split parameter's: this rank's shard of it).  A sequence that does
    not divide by the model axis runs whole (``ParallelCtx.seq_whole``;
    with ``global_batch``, the share is cut already and ``pctx`` says
    so)."""
    if pctx.world_size == 1:
        return loss_and_grads(params, batch, cfg, rcfg, pctx, tcfg,
                              router_bias)
    rows = batch["targets"].shape[0] if global_batch is None \
        else global_batch
    if sharding.batch_replicated(pctx, rows):
        pctx = dataclasses.replace(pctx, batch_replicated=True)
    if global_batch is None:
        if sharding.stream_whole(pctx, batch["targets"].shape[1]):
            pctx = dataclasses.replace(pctx, seq_whole=True)
        batch = sharding.local_batch(batch, pctx)
    loss, drops, counts, grads = loss_and_grads(
        params, batch, cfg, rcfg, pctx, tcfg, router_bias)
    specs = sharding.lm_param_specs(params, pctx)
    with torch.no_grad():
        reduce_grads(grads, [s.reduce for s in specs])
    return loss, drops, counts, grads


def make_train_step(cfg: ModelConfig, rcfg: RuntimeConfig, pctx: ParallelCtx,
                    optimizer: Optimizer, tcfg: TrainConfig = TrainConfig(),
                    *, global_batch: int | None = None):
    """``(state, batch) -> (state, metrics)``; ``batch`` is the global
    batch (on a mesh each rank takes its share), or with ``global_batch``
    this rank's share of a global batch of that many rows (a mesh cell's
    step, ``launch.specs``)."""
    def train_step(state: TrainState, batch: dict):
        params = state.params
        loss, drops, counts, grads = global_grads(
            params, batch, cfg, rcfg, pctx, tcfg, state.router_bias,
            global_batch=global_batch)
        with torch.no_grad():
            specs = None
            if pctx.world_size > 1:
                specs = sharding.lm_param_specs(params, pctx)
            grads, gnorm = clip_by_global_norm(
                grads, tcfg.clip_norm,
                spans=None if specs is None else [s.span for s in specs])
            opt_state = optimizer.update(grads, state.opt_state,
                                         list(params.parameters()),
                                         state.step, placements=specs)
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


# ---------------- the state at global shapes (checkpoints) ----------------

def _leaves(state: TrainState, pctx: ParallelCtx):
    """(key, tensor, per-dimension groups) of every tensor of ``state``:
    the parameters (each dimension split over its placement's group), then
    the optimizer's per-parameter state (AdamW's two moments, placed as
    their parameter; Adafactor's v_row without the last dimension and
    v_col without the second last of a factored parameter)."""
    named = list(state.params.named_parameters())
    dims = [(None,) * p.dim() for _, p in named]
    if pctx.world_size > 1:
        dims = [s.dims for s in sharding.lm_param_specs(state.params, pctx)]
    opt = state.opt_state
    for (name, p), dm in zip(named, dims):
        yield f"params/{name}", p, dm
    for field in opt._fields:
        for (name, p), t, dm in zip(named, getattr(opt, field), dims):
            if field == "v_row" and p.dim() >= 2:
                dm = dm[:-1]
            elif field == "v_col":
                dm = dm[:-2] + dm[-1:] if p.dim() >= 2 else ()
            yield f"opt_state/{field}/{name}", t, dm


def global_shapes(state: TrainState, pctx: ParallelCtx) -> dict:
    """Every leaf's key -> its global shape (what ``state_to_global``
    gives), on any mesh."""
    out = {}
    for key, t, dims in _leaves(state, pctx):
        out[key] = [s * (1 if g is None else g.size)
                    for s, g in zip(t.shape, dims)]
    if state.router_bias is not None:
        out["router_bias"] = list(state.router_bias.shape)
    out["step"] = []
    return out


@torch.no_grad()
def state_to_global(state: TrainState, pctx: ParallelCtx) -> dict:
    """The train state as one flat mapping at global shapes, the same on
    every rank (collective on a mesh): every split dimension gathered over
    its group."""
    out = {}
    for key, t, dims in _leaves(state, pctx):
        out[key] = sharding.gather_whole(t, dims)
    if state.router_bias is not None:
        out["router_bias"] = state.router_bias
    out["step"] = int(state.step)
    return out


@torch.no_grad()
def state_from_global(state: TrainState, tree: dict,
                      pctx: ParallelCtx) -> TrainState:
    """``state`` with every tensor overwritten in place by this rank's
    share of the global ``tree`` (``state_to_global``'s layout, from a
    mesh of any size)."""
    for key, t, dims in _leaves(state, pctx):
        a = tree[key]
        a = a if isinstance(a, torch.Tensor) else torch.from_numpy(a)
        t.copy_(sharding.cut(a, dims).to(t.device))
    bias = state.router_bias
    if bias is not None:
        a = tree["router_bias"]
        bias = torch.as_tensor(a).to(device=bias.device, dtype=bias.dtype)
    return TrainState(state.params, state.opt_state, bias,
                      int(tree["step"]))
