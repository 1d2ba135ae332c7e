"""The train, prefill and decode steps and their argument specs for every
(arch x shape) cell.

Mirrors ``repro.launch.specs``: :func:`build_cell` assembles, for one
(architecture, shape, parallel context) cell, the step (train_step /
prefill_step / serve_step) and its argument shapes, and
:func:`shape_supported`, :func:`supported_shapes` and :func:`runtime_for`
say which shapes an arch runs and with which runtime.  The argument
shapes are tensors on the ``meta`` device (built by the port's own init
functions there), which take the place of ``jax.eval_shape``: nothing is
allocated.

On a mesh (a ``pctx`` of more than one rank, ``launch.mesh``) a cell's
``in_shardings`` holds the port's placements
(``repro_torch.parallel.sharding``: one entry per dimension) as the
reference's cells hold their PartitionSpecs: a train cell's
``(TrainState(params, opt_state, router_bias (None, None), step ()),
batch)``, a prefill cell's ``(params, batch)``, a decode cell's ``(params,
caches, batch)`` (``sharding.cache_specs``: one entry a layer); each
``params`` a dict by parameter name, each ``opt_state`` a dict by field of
such dicts.  Its ``arg_shapes`` are this rank's shards (the decode cell's
caches too), and its step takes this rank's share of the batch (rows over
the data axis, the sequence over the model axis, ``sharding.
batch_specs``).  On one rank ``in_shardings`` is None and the step takes
the whole batch.  ``out_shardings`` is None, and the multi-pod dry run
(``launch/dryrun.py``) is not ported; the runtime has no counterpart of
the reference's scan and analysis knobs.  A train cell's optimizer is in
``meta["optimizer"]`` (and its microbatches in ``meta["microbatches"]``),
so a caller builds the real state with the step's own optimizer.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec, get_config
from repro_torch.core.balancer import BalancerConfig
from repro_torch.models.model import (decode_step, forward, init_caches,
                                      init_lm, init_router_bias)
from repro_torch.models.transformer import ParallelCtx, RuntimeConfig
from repro_torch.optim import adafactor, adamw
from repro_torch.parallel import sharding
from repro_torch.train.loop import (TrainConfig, TrainState,
                                    init_train_state, make_train_step)

__all__ = ["Cell", "build_cell", "shape_supported", "supported_shapes",
           "runtime_for"]

# Archs whose AdamW state cannot fit a device's memory train with Adafactor
# (the reference's set).
_BIG = {"qwen2-72b", "mistral-large-123b", "deepseek-v3-671b", "dbrx-132b",
        "qwen3-235b-a22b", "glm45-106b-a12b", "jamba-v0.1-52b",
        "internvl2-26b"}


class Cell(NamedTuple):
    arch: str
    shape: str
    step_fn: Callable
    arg_shapes: tuple
    in_shardings: Any
    out_shardings: Any
    donate: tuple[int, ...]
    meta: dict


def shape_supported(cfg: ModelConfig, shape: str) -> bool:
    if shape in cfg.shape_skips:
        return False
    spec = SHAPES[shape]
    if spec.kind == "decode" and not cfg.has_decode:
        return False
    return True


def supported_shapes(cfg: ModelConfig) -> list[str]:
    return [s for s in SHAPES if shape_supported(cfg, s)]


def runtime_for(cfg: ModelConfig, shape: ShapeSpec, *,
                balancer_mode: str = "ultraep", analysis: bool = False,
                **overrides) -> RuntimeConfig:
    """bf16, the balancer in ``balancer_mode`` (the arch's slots, u_min 8),
    512-key blocks (2048 for analysis) and remat for train shapes."""
    kw = dict(
        balancer=BalancerConfig(mode=balancer_mode,
                                n_slot=cfg.moe.n_slot if cfg.moe else 2,
                                u_min=8),
        dtype=torch.bfloat16,
        block_kv=2048 if analysis else 512,
        remat=shape.kind == "train",
    )
    kw.update(overrides)
    return RuntimeConfig(**kw)


def _batch_shapes(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """The cell's batch on the ``meta`` device: tokens (and targets when
    training), or a stub frontend's bf16 inputs as the reference's cells
    give them: frames (B, S, D) in place of the tokens, patches (B, P, D)
    beside them except at decode."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        S = 1
    meta = dict(dtype=torch.int32, device="meta")
    act = dict(dtype=torch.bfloat16, device="meta")
    out = {"tokens": torch.empty((B, S), **meta)}
    if shape.kind == "train":
        out["targets"] = torch.empty((B, S), **meta)
    if cfg.frontend == "audio_frames":
        out["frames"] = torch.empty((B, S, cfg.d_model), **act)
        out.pop("tokens")
    if cfg.frontend == "vision_patches" and shape.kind != "decode":
        out["patches"] = torch.empty((B, cfg.num_patches, cfg.d_model), **act)
    return out


def build_cell(arch: str, shape_name: str, pctx: ParallelCtx, *,
               balancer_mode: str = "ultraep", analysis: bool = False,
               num_layers_override: int | None = None, microbatches: int = 1,
               rcfg_overrides: dict | None = None) -> Cell:
    """Assemble one (arch x shape) cell."""
    cfg = get_config(arch)
    if num_layers_override is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers_override)
    shape = SHAPES[shape_name]
    if not shape_supported(get_config(arch), shape_name):
        raise ValueError(f"{arch} skips {shape_name}")
    rcfg = runtime_for(cfg, shape, balancer_mode=balancer_mode,
                       analysis=analysis, **(rcfg_overrides or {}))
    params_shape = init_lm(cfg, rcfg, pctx, None, device="meta")
    bshapes = _batch_shapes(cfg, shape)
    meta = {"cfg": cfg, "rcfg": rcfg, "shape": shape}
    mesh = pctx.world_size > 1
    pspecs = bspecs = None
    if mesh:
        pspecs = params_shape.layout
        bspecs = sharding.batch_specs(cfg, sharding.from_ctx(pctx),
                                      shape.kind, shape.global_batch)
        bshapes = sharding.local_batch(bshapes, pctx, shape.kind)

    if shape.kind == "train":
        opt = adafactor(1e-4) if arch in _BIG else adamw(3e-4)
        state_shape = init_train_state(params_shape, opt, cfg)
        step = make_train_step(cfg, rcfg, pctx, opt,
                               TrainConfig(microbatches=microbatches),
                               global_batch=shape.global_batch if mesh
                               else None)
        meta["optimizer"] = opt
        meta["microbatches"] = microbatches
        shardings = None
        if mesh:
            kind = "adafactor" if arch in _BIG else "adamw"
            shardings = (TrainState(
                params=pspecs,
                opt_state=sharding.opt_state_specs(pspecs, kind),
                router_bias=(None if state_shape.router_bias is None
                             else (None, None)),
                step=()), bspecs)
        return Cell(arch, shape_name, step, (state_shape, bshapes),
                    shardings, None, (0,), meta)

    # The serve steps route with the initial (zero) router bias, as the
    # reference's cells do, made on the parameters' device.
    if shape.kind == "prefill":
        @torch.no_grad()
        def prefill_step(params, batch):
            bias = init_router_bias(cfg, device=params.embedding.device)
            logits, _aux, drops, counts = forward(params, batch, cfg, rcfg,
                                                  pctx, router_bias=bias)
            return logits, drops, counts

        return Cell(arch, shape_name, prefill_step, (params_shape, bshapes),
                    (pspecs, bspecs) if mesh else None, None, (), meta)

    caches_shape = init_caches(cfg, shape.global_batch, shape.seq_len, rcfg,
                               device="meta", pctx=pctx)
    cspecs = sharding.cache_specs(cfg, sharding.from_ctx(pctx),
                                  shape.global_batch) if mesh else None

    @torch.no_grad()
    def serve_step(params, caches, batch):
        bias = init_router_bias(cfg, device=params.embedding.device)
        return decode_step(params, caches, batch["tokens"], cfg, rcfg, pctx,
                           router_bias=bias)

    return Cell(arch, shape_name, serve_step,
                (params_shape, caches_shape, bshapes),
                (pspecs, cspecs, bspecs) if mesh else None, None, (1,), meta)
