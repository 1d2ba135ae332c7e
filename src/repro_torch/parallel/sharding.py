"""Placement of the batch, the parameters and the optimizer state on a mesh.

Mirrors the parts of ``repro.parallel.sharding`` the port runs: where a
tensor lives, not how it is computed.  On a mesh of D data rows x R EP
ranks (``repro_torch.launch.mesh``; ``ParallelCtx`` ``data`` and
``group``):

* :func:`batch_specs`: a data rank holds its rows of the global batch
  (rows ``[d B / D, (d + 1) B / D)``), or the whole batch where B does not
  divide by D, as the reference replicates it (``batch_specs``'
  ``global_batch`` rule).  Every EP rank of a data row holds the same
  rows: the MoE block splits their sequence (``transformer._ep_moe_block``).
* :func:`lm_param_specs`: each parameter's :class:`Placement`.  Expert
  rows are sharded over EP (``init_moe_params`` / ``convert.lm_params``
  with ``ep_rank``, ``ep_size``), everything else is replicated.  A
  replicated parameter that the MoE block uses on the rank's slice of the
  tokens (the router and the shared expert) gets only that slice's
  gradient, so its gradient is summed over data x EP; every other
  replicated parameter is used whole on each EP rank and is summed over
  the data group; expert gradients are summed over the data group.
* :func:`opt_state_specs`: AdamW's moments mirror their parameter's
  placement and are also sharded over the parameter's replicas (data x EP
  for a replicated parameter, data for an expert shard) on the first
  dimension that divides by the replica count (the reference's ``_dd``
  rule); where none divides, the moments stay replicated.

What differs from the reference's layout, and why the results agree.  The
reference shards dense weights over the model axis (tensor parallelism,
``_mm``) and over the data axes (FSDP, ``_dd``), and GSPMD gathers them
where they are used.  The port keeps dense weights whole on every rank
(tensor parallelism is not ported) and shards only AdamW's moments, with
the update of each shard followed by an ``all_gather`` of the parameter
over its replicas (``repro_torch.optim.optimizer``).  Both compute the
gradient of one global loss and apply the same elementwise AdamW to it,
so placement changes where the arithmetic runs, not its values: a
parameter's update is bitwise the unsharded one, and only the order of the
cross-rank gradient sums differs.  On a factored group the EP ranks are
rack-major, as the reference's ``(rack, model)`` axes.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["Placement", "MomentShard", "batch_specs", "batch_replicated",
           "local_batch", "lm_param_specs", "opt_state_specs"]


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one parameter lives.  ``expert``: its rows are this EP rank's
    experts (global rows ``[ep_rank * n, (ep_rank + 1) * n)``).
    ``reduce``: the group whose sum of the ranks' gradients is the
    parameter's gradient (None: no sum); ``replicas``: the group of ranks
    holding the same values (None: this rank alone)."""

    expert: bool
    reduce: object
    replicas: object


@dataclasses.dataclass(frozen=True)
class MomentShard:
    """This rank's part of a parameter's AdamW moments: slice ``index`` of
    ``count`` along ``dim`` over the replica ``group`` (count 1: whole)."""

    group: object
    dim: int
    count: int
    index: int

    @property
    def whole(self) -> bool:
        return self.count == 1

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a tensor of the parameter's shape (a
        view)."""
        if self.whole:
            return t
        n = t.shape[self.dim] // self.count
        return t.narrow(self.dim, self.index * n, n)

    def shape(self, full) -> tuple:
        s = list(full)
        if not self.whole:
            s[self.dim] //= self.count
        return tuple(s)


def batch_specs(pctx, global_batch: int) -> slice:
    """This data rank's rows of a global batch of ``global_batch`` rows:
    its contiguous share, or every row where the batch does not divide
    over the data group (replicated, as the reference)."""
    D, d = pctx.data_size, pctx.data_rank
    if D == 1 or batch_replicated(pctx, global_batch):
        return slice(0, global_batch)
    b = global_batch // D
    return slice(d * b, (d + 1) * b)


def batch_replicated(pctx, global_batch: int) -> bool:
    """True where every data row holds the whole global batch (it does
    not divide over the data group)."""
    return pctx.data_size > 1 and global_batch % pctx.data_size != 0


def local_batch(batch: dict, pctx) -> dict:
    """``batch`` (every value (B, ...)) cut to this data rank's rows."""
    B = next(iter(batch.values())).shape[0]
    rows = batch_specs(pctx, B)
    return {k: v[rows] for k, v in batch.items()}


def lm_param_specs(params, pctx) -> list[Placement]:
    """One :class:`Placement` per tensor of ``params.parameters()``, in
    that order (built from the blocks, not from parameter names)."""
    expert, split = set(), set()
    for bp in params.layers:
        mp = bp.moe
        if mp is None:
            continue
        expert.update(id(w) for w in (mp.w1, mp.w3, mp.w2))
        split.update(id(w) for w in (mp.router, mp.shared_w1, mp.shared_w3,
                                     mp.shared_w2) if w is not None)
    world = pctx.world_group
    out = []
    for p in params.parameters():
        if id(p) in expert:
            out.append(Placement(True, pctx.data, pctx.data))
        elif id(p) in split:        # used on the rank's token slice
            out.append(Placement(False, world, world))
        else:
            out.append(Placement(False, pctx.data, world))
    return out


def opt_state_specs(params, specs: list[Placement]) -> list[MomentShard]:
    """Each parameter's moment shard over its replicas (see the module's
    notes): the first dimension that divides by the replica count, else
    whole."""
    out = []
    for p, pl in zip(params, specs):
        g = pl.replicas
        n = 1 if g is None else g.size
        dim = next((i for i, s in enumerate(p.shape) if s % n == 0), None)
        if n == 1 or dim is None:
            out.append(MomentShard(None, 0, 1, 0))
        else:
            out.append(MomentShard(g, dim, n, g.rank))
    return out
