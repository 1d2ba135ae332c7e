"""Pipeline parallelism over a group of ranks (GPipe).

Mirrors ``repro.parallel.pipeline``: the layers are split into
``num_stages`` contiguous groups, one a rank of ``group``, and M
microbatches stream through the stages in M + n - 1 ticks (bubble
fraction (n - 1) / (M + n - 1)).  At tick t stage s runs microbatch
t - s when 0 <= t - s < M: stage 0 takes it from ``x_mb``, every other
stage from the previous stage's send of the tick before, and each stage
hands its output to the next one point to point (``collectives.sendrecv``,
where the reference's scan uses ``ppermute``).  The last stage banks the
finished microbatches and broadcasts them to every stage at the end, as
the reference's final ``psum`` does.

``pipeline_apply`` is layout-agnostic: ``stage_fn(x, stage_params) -> x``
applies this stage's layers.  As in the reference, nothing in the model
calls it.  It runs without a gradient (the reference differentiates its
scan; no trainer here pipelines).
"""

from __future__ import annotations

import torch

from repro_torch.parallel import collectives

__all__ = ["pipeline_apply"]


@torch.no_grad()
def pipeline_apply(x_mb: torch.Tensor, stage_params, stage_fn, group,
                   num_stages: int) -> torch.Tensor:
    """Run microbatches through the stages (every rank of ``group`` calls
    it with its own stage's parameters).

    Args:
      x_mb: (M, ...) stacked microbatch inputs (the same on every stage;
        stage 0 injects them).
      stage_params: this stage's parameters.
      stage_fn: (x, stage_params) -> x, this stage's layers; it keeps x's
        shape and dtype.
      group: an :class:`repro_torch.parallel.collectives.EPGroup` of
        ``num_stages`` ranks; its rank is the stage.
      num_stages: the stage count (the group's size).

    Returns:
      (M, ...) outputs, the same on every stage.
    """
    n = num_stages
    if group.size != n:
        raise ValueError(f"{n} stages on a group of {group.size} ranks")
    M = x_mb.shape[0]
    s = group.rank
    buf = torch.empty_like(x_mb[0])
    outs = torch.zeros_like(x_mb)
    for t in range(M + n - 1):
        active = 0 <= t - s < M
        y = None
        if active:
            y = stage_fn(x_mb[t] if s == 0 else buf, stage_params)
            if s == n - 1:
                outs[t - s] = y
        send = y if active and s < n - 1 else None
        recv = s > 0 and 0 <= t - (s - 1) < M
        nxt = torch.empty_like(buf) if recv else None
        collectives.sendrecv(group, send, s + 1 if send is not None else None,
                             nxt, s - 1 if recv else None)
        if recv:
            buf = nxt
    return collectives.broadcast(group, outs, n - 1)
