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
* :func:`all_reduce`: the sum over ranks.

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

__all__ = ["EPGroup", "init", "subgroup", "destroy", "all_gather",
           "all_to_all", "reduce_scatter", "all_reduce"]


class EPGroup:
    """One EP group: the process group, this process's rank in it, its size
    and backend."""

    def __init__(self, group=None):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = dist.get_backend(group)

    def __repr__(self) -> str:
        return (f"EPGroup(rank={self.rank}, size={self.size}, "
                f"backend={self.backend!r})")


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
