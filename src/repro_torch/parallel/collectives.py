"""EP-group collectives over ``torch.distributed``.

The only module of the port that calls ``torch.distributed``: it holds the
EP group handle (:class:`EPGroup`: the group, this process's rank in it,
``jax.lax.axis_index``'s counterpart, and its size) and the operations the
MoE layer and the model need, in the JAX package's terms
(``jax.lax.all_gather``, ``all_to_all`` with ``tiled=False``,
``psum_scatter`` and ``psum``):

* :func:`all_gather`: (...) on every rank -> (R, ...), rank-major;
* :func:`all_to_all`: an (R, ...) destination-major buffer -> (R, ...)
  source-major, equal splits on axis 0: one ``all_to_all_single`` over a
  contiguous buffer, so no split size comes from the host and nothing
  syncs;
* :func:`reduce_scatter`: (R, ...) -> (...), the sum over ranks of each
  rank's row ``rank``;
* :func:`all_reduce`: the sum over ranks;
* :func:`all_to_all_async`: :func:`all_to_all` started and returned as a
  handle whose ``wait()`` gives the received buffer (the overlap driver's
  exchange of the next chunk, under the current chunk's FFN).

A factored group (:func:`factor`: ``racks`` x ``L`` ranks, the two-level
topology of ``repro.core.topology``, rank-major: rank ``r`` is rack ``r //
L``, lane ``r % L``) also holds its ``rack`` subgroup (the ranks of its
lane, one a rack: ``jax.lax`` over the rack axis) and its ``lane``
subgroup (the ranks of its rack).  ``torch.distributed.new_group`` is
collective over the default group: every rank calls it for every
subgroup, in one order, including those it is not in, so :func:`factor`
makes them all at once, when the group is built.

Gradients follow JAX's transpose rules where the MoE layer needs them: the
backward of ``all_to_all`` is the same exchange of the gradient, of
``reduce_scatter`` an ``all_gather`` (each an autograd Function when its
input requires a gradient; every rank of the group runs the backward, in
the same order as the forward).  ``all_gather`` (the counts, the model's
sequence split) and ``all_reduce`` (the ``replicated`` mode's decode, the
summed statistics) raise under a gradient: model-level multi-rank
training is not ported.

NCCL carries CUDA tensors, one card per rank.  gloo carries CPU tensors,
and CUDA tensors too where several ranks share one card (which NCCL
refuses): on PyTorch 2.11 with CUDA 12.8 gloo takes CUDA tensors in all
four of these collectives (chip_smoke.py phase 9 probes each on the
card), staging them through the host itself, so this module hands every
backend its tensors as they are.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

__all__ = ["EPGroup", "init", "subgroup", "factor", "destroy", "all_gather",
           "all_to_all", "all_to_all_async", "reduce_scatter", "all_reduce"]


class EPGroup:
    """One EP group: the process group, this process's rank in it, its size
    and backend; on a factored group (:func:`factor`) also ``racks``, the
    ``rack`` subgroup (this lane's ranks, one a rack) and the ``lane``
    subgroup (this rack's ranks), else ``racks`` None."""

    def __init__(self, group=None, *, racks: int | None = None, rack=None,
                 lane=None):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = dist.get_backend(group)
        self.racks = racks
        self.rack = rack
        self.lane = lane

    @property
    def factored(self) -> bool:
        return self.racks is not None

    def __repr__(self) -> str:
        tier = "" if self.racks is None else f", racks={self.racks}"
        return (f"EPGroup(rank={self.rank}, size={self.size}, "
                f"backend={self.backend!r}{tier})")


def init(backend: str, *, world_size: int, rank: int,
         init_method: str = "env://", timeout_s: float = 600.0) -> EPGroup:
    """Start this process's default group and return it as an EPGroup.

    ``backend`` "nccl" (CUDA, one card per rank) or "gloo" (the CPU, or
    several ranks on one card); ``init_method`` is
    "env://" under torchrun or ``tcp://localhost:<port>``."""
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return EPGroup()


def subgroup(ranks: list[int]) -> EPGroup | None:
    """An EP group of some ranks of the default group (every rank of the
    default group must call this); None on a rank outside it."""
    group = dist.new_group(ranks)
    return EPGroup(group) if dist.get_rank() in ranks else None


def factor(racks: int) -> EPGroup:
    """The default group factored into ``racks`` racks of ``world /
    racks`` ranks (rack-major): the same ranks and process group, plus
    this rank's lane subgroup (its rack's ranks) and rack subgroup (its
    lane's ranks).

    Collective over the default group: every rank calls it with the same
    ``racks``, in the same order as its other group calls.  It makes every
    lane subgroup (one a rack), then every rack subgroup (one a lane)."""
    R = dist.get_world_size()
    if racks < 1 or R % racks != 0:
        raise ValueError(f"racks={racks} must divide the group's {R} ranks")
    L = R // racks
    me = dist.get_rank()
    lane_g = rack_g = None
    for g in range(racks):
        members = [g * L + l for l in range(L)]
        pg = dist.new_group(members)
        if me in members:
            lane_g = EPGroup(pg)
    for l in range(L):
        members = [g * L + l for g in range(racks)]
        pg = dist.new_group(members)
        if me in members:
            rack_g = EPGroup(pg)
    return EPGroup(racks=racks, rack=rack_g, lane=lane_g)


def destroy() -> None:
    """End every group of this process."""
    dist.destroy_process_group()


def _grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def all_gather(g: EPGroup, x: torch.Tensor) -> torch.Tensor:
    """(...) -> (R, ...): every rank's ``x`` in rank order."""
    if _grad(x):
        raise ValueError("all_gather has no backward here: model-level "
                         "multi-rank training is not ported")
    return _all_gather(g, x)


def _all_gather(g: EPGroup, x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    out = x.new_empty((g.size,) + tuple(x.shape))
    dist.all_gather_into_tensor(out.view(-1), x.view(-1), group=g.group)
    return out


def all_to_all(g: EPGroup, buf: torch.Tensor) -> torch.Tensor:
    """(R, ...) -> (R, ...): row s of rank r's output is row r of rank s's
    ``buf`` (``jax.lax.all_to_all(buf, axis, 0, 0, tiled=False)``)."""
    if _grad(buf):
        return _AllToAll.apply(g, buf)
    return _all_to_all(g, buf)


def _all_to_all(g: EPGroup, buf: torch.Tensor) -> torch.Tensor:
    if buf.shape[0] != g.size:
        raise ValueError(f"all_to_all needs {g.size} rows on axis 0, not "
                         f"{buf.shape[0]}")
    buf = buf.contiguous()
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=g.group)
    return out


def reduce_scatter(g: EPGroup, buf: torch.Tensor) -> torch.Tensor:
    """(R, ...) -> (...): the sum over ranks of row ``g.rank``
    (``jax.lax.psum_scatter(buf, axis, scatter_dimension=0,
    tiled=False)``), in ``buf``'s dtype."""
    if _grad(buf):
        return _ReduceScatter.apply(g, buf)
    return _reduce_scatter(g, buf)


def _reduce_scatter(g: EPGroup, buf: torch.Tensor) -> torch.Tensor:
    if buf.shape[0] != g.size:
        raise ValueError(f"reduce_scatter needs {g.size} rows on axis 0, "
                         f"not {buf.shape[0]}")
    buf = buf.contiguous()
    out = buf.new_empty(tuple(buf.shape[1:]))
    dist.reduce_scatter_tensor(out.view(-1), buf.view(-1), group=g.group)
    return out


def all_reduce(g: EPGroup, x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks (``jax.lax.psum``), as a new tensor; no gradient
    (see the module's notes)."""
    if _grad(x):
        raise ValueError("all_reduce has no backward here: the replicated "
                         "dispatch mode serves decode only; train with a2a "
                         "on one rank's model or the layer")
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=g.group)
    return out


class AsyncExchange:
    """A started :func:`all_to_all`; ``wait()`` returns the received buffer
    (the same call again returns it again)."""

    def __init__(self, out: torch.Tensor, work):
        self._out = out
        self._work = work

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
            self._work = None
        return self._out


def all_to_all_async(g: EPGroup, buf: torch.Tensor) -> AsyncExchange:
    """:func:`all_to_all` started without waiting for it (no gradient:
    under one, call :func:`all_to_all`).  Every rank must start its
    exchanges in the same order, as with the synchronous calls."""
    if _grad(buf):
        raise ValueError("all_to_all_async has no backward: under a "
                         "gradient use all_to_all")
    if buf.shape[0] != g.size:
        raise ValueError(f"all_to_all needs {g.size} rows on axis 0, not "
                         f"{buf.shape[0]}")
    buf = buf.contiguous()
    out = torch.empty_like(buf)
    work = dist.all_to_all_single(out, buf, group=g.group, async_op=True)
    return AsyncExchange(out, work)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, buf):
        ctx.g = g
        return _all_to_all(g, buf)

    @staticmethod
    def backward(ctx, dy):
        return None, _all_to_all(ctx.g, dy)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, buf):
        ctx.g = g
        return _reduce_scatter(g, buf)

    @staticmethod
    def backward(ctx, dy):
        return None, _all_gather(ctx.g, dy)
