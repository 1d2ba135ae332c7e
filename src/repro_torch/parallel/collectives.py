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
* :func:`all_reduce`: the sum over ranks; :func:`all_max`: the max
  (``pmax``, no gradient);
* :func:`shard`: this rank's slice of a replicated tensor along a
  dimension (the inverse of :func:`all_gather`);
* :func:`gather_along`, :func:`scatter_along`, :func:`sum_grad`: the
  pairs of the sharded layout (``repro_torch.parallel.sharding``), an
  all-gather along a dimension whose backward is a reduce-scatter, a
  reduce-scatter along a dimension whose backward is an all-gather, and
  the identity whose backward is an all-reduce (the dual of
  :func:`all_reduce`);
* :func:`all_reduce_`, :func:`broadcast`, :func:`sendrecv`,
  :func:`barrier`: an in-place sum (gradient buckets), a broadcast and a
  point-to-point exchange (the pipeline), with no gradient, and a
  barrier;
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

Gradients follow JAX's transpose rules, under one convention: every rank
of an EP group computes the replicated (dense) part of the model and the
loss redundantly, so the cotangent that reaches a replicated tensor is the
whole gradient on every rank.  Each op below is an autograd Function only
where its input requires a gradient, and every rank of the group runs the
backward in the same order as the forward:

* ``all_to_all``: the same exchange of the gradient;
* ``reduce_scatter``: an ``all_gather`` of the gradient;
* ``all_gather`` (rank slices -> replicated): the rank's own slice of the
  (replicated) cotangent, with no communication;
* :func:`shard` (a replicated tensor -> the rank's slice, the MoE block's
  sequence split): an ``all_gather`` of the slices' cotangents, so the
  replicated input again gets the whole gradient on every rank;
* ``all_reduce`` (the summed aux loss and statistics): the identity, so
  each rank back-propagates its own term of the sum.

The sharded layout's pairs follow the other convention, Megatron's
sequence parallelism: a tensor that every rank of the group holds whole
(a gathered sequence, a gathered weight) carries on each rank only that
rank's part of its cotangent, and the parts sum to the whole gradient.

* :func:`gather_along` (shards -> whole along ``dim``): a reduce-scatter
  of the cotangent along ``dim``, the sum of the ranks' parts of this
  rank's slice;
* :func:`scatter_along` (partial sums -> this rank's slice of the sum): an
  all-gather of the slices' cotangents along ``dim``;
* :func:`sum_grad` (the identity): an all-reduce of the cotangent, where a
  replicated value with the whole cotangent on every rank enters a region
  whose ranks each hold a part;
* :func:`reduce_whole` (partial sums -> their sum, whole on every rank:
  a row-parallel exit onto a stream every rank holds whole): an
  all-reduce of the cotangent's parts, each partial's cotangent being the
  whole one;
* :func:`first_copy` (copies of one value, which may differ -> group rank
  0's on every rank): the mean of the cotangent's parts on every rank's
  own copy, as JAX transposes a ``shard_map`` output that its spec
  declares replicated (each device's copy takes the cotangent over the
  group's size).

Each works over any group: the model (EP) group, a factored group as
one, or the data group.

The same ops serve the data group (a ``ParallelCtx``'s ``data`` group:
the global loss's sum, the MoE statistics) and the optimizer's groups
(the gradients' in-place sums, the ``all_gather`` of updated parameter
shards).

Counts.  Every call adds its operand's bytes (what this rank puts in: the
input of a gather, an exchange, a reduction or a broadcast, the tensor a
:func:`sendrecv` sends) and one call to its kind's count
(``bytes_by_kind``, ``calls_by_kind``; kinds ``KINDS``), as the reference
counts each collective's operand sizes in the compiled HLO
(``repro.roofline.analysis.parse_hlo_collectives``).  :func:`reset_counts`
sets them to 0 and :func:`counts` reads them, like the kernels' launch
counters; ``repro_torch.roofline`` reads them for its collective term.

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
           "all_to_all", "all_to_all_async", "reduce_scatter", "all_reduce",
           "all_reduce_", "all_max", "shard", "gather_along", "scatter_along",
           "sum_grad", "reduce_whole", "first_copy", "barrier", "sendrecv", "broadcast",
           "world_size", "world_rank", "KINDS", "bytes_by_kind",
           "calls_by_kind", "reset_counts", "counts"]

# The collective kinds counted, as the reference's HLO parser names them
# (all-to-all, all-gather, reduce-scatter, all-reduce; broadcast and
# point-to-point, which a collective-permute is there).
KINDS = ("all_to_all", "all_gather", "reduce_scatter", "all_reduce",
         "broadcast", "sendrecv")
bytes_by_kind = dict.fromkeys(KINDS, 0)
calls_by_kind = dict.fromkeys(KINDS, 0)


def reset_counts() -> None:
    """Set every kind's bytes and calls to 0."""
    for kind in KINDS:
        bytes_by_kind[kind] = calls_by_kind[kind] = 0


def counts() -> dict:
    """{kind: {"bytes": n, "calls": n}} since the last reset."""
    return {kind: {"bytes": bytes_by_kind[kind],
                   "calls": calls_by_kind[kind]} for kind in KINDS}


def _count(kind: str, x: torch.Tensor | None) -> None:
    bytes_by_kind[kind] += 0 if x is None else x.numel() * x.element_size()
    calls_by_kind[kind] += 1


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


def world_size() -> int:
    """Ranks of the default group."""
    return dist.get_world_size()


def world_rank() -> int:
    """This process's rank in the default group."""
    return dist.get_rank()


def subgroup(ranks: list[int]) -> EPGroup | None:
    """An EP group of some ranks of the default group (every rank of the
    default group must call this); None on a rank outside it."""
    group = dist.new_group(ranks)
    return EPGroup(group) if dist.get_rank() in ranks else None


def factor(racks: int, ranks: list[int] | None = None) -> EPGroup | None:
    """An EP group of ``ranks`` (default: the whole default group) factored
    into ``racks`` racks of ``len(ranks) / racks`` ranks (rack-major): the
    group, plus this rank's lane subgroup (its rack's ranks) and rack
    subgroup (its lane's ranks); None on a rank outside ``ranks``.

    Collective over the default group: every rank calls it with the same
    arguments, in the same order as its other group calls.  It makes the
    group (unless it is the default one), every lane subgroup (one a
    rack), then every rack subgroup (one a lane)."""
    pg = None
    if ranks is None:
        ranks = list(range(dist.get_world_size()))
    else:
        pg = dist.new_group(ranks)
    R = len(ranks)
    if racks < 1 or R % racks != 0:
        raise ValueError(f"racks={racks} must divide the group's {R} ranks")
    L = R // racks
    me = dist.get_rank()
    lane_g = rack_g = None
    for g in range(racks):
        members = [ranks[g * L + l] for l in range(L)]
        sub = dist.new_group(members)
        if me in members:
            lane_g = EPGroup(sub)
    for l in range(L):
        members = [ranks[g * L + l] for g in range(racks)]
        sub = dist.new_group(members)
        if me in members:
            rack_g = EPGroup(sub)
    if me not in ranks:
        return None
    return EPGroup(pg, racks=racks, rack=rack_g, lane=lane_g)


def destroy() -> None:
    """End every group of this process."""
    dist.destroy_process_group()


def _grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def all_gather(g: EPGroup, x: torch.Tensor) -> torch.Tensor:
    """(...) -> (R, ...): every rank's ``x`` in rank order; under a
    gradient its backward is this rank's row of the cotangent."""
    if _grad(x):
        return _AllGather.apply(g, x)
    return _all_gather(g, x)


def _all_gather(g: EPGroup, x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    out = x.new_empty((g.size,) + tuple(x.shape))
    _count("all_gather", x)
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
    _count("all_to_all", buf)
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
    _count("reduce_scatter", buf)
    dist.reduce_scatter_tensor(out.view(-1), buf.view(-1), group=g.group)
    return out


def all_reduce(g: EPGroup, x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks (``jax.lax.psum``), as a new tensor; under a
    gradient its backward is the identity (see the module's notes)."""
    if _grad(x):
        return _AllReduce.apply(g, x)
    return _all_reduce(g, x)


def _all_reduce(g: EPGroup, x: torch.Tensor) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    _count("all_reduce", out)
    dist.all_reduce(out, group=g.group)
    return out


def all_reduce_(g: EPGroup, x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks written into ``x`` (contiguous, no gradient)."""
    _count("all_reduce", x)
    dist.all_reduce(x, group=g.group)
    return x


def all_max(g: EPGroup, x: torch.Tensor) -> torch.Tensor:
    """The max over ranks (``jax.lax.pmax``), as a new tensor, no
    gradient."""
    out = x.detach().clone(memory_format=torch.contiguous_format)
    _count("all_reduce", out)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=g.group)
    return out


def shard(g: EPGroup, x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's slice of a replicated ``x`` along ``dim`` (which must
    divide by the group's size); under a gradient its backward gathers the
    slices' cotangents back along ``dim``."""
    if x.shape[dim] % g.size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {g.size} ranks")
    if _grad(x):
        return _Shard.apply(g, x, dim)
    return _shard(g, x, dim)


def _shard(g: EPGroup, x: torch.Tensor, dim: int) -> torch.Tensor:
    n = x.shape[dim] // g.size
    return x.narrow(dim, g.rank * n, n)


def _unshard(g: EPGroup, xs: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's slice along ``dim``, put back together."""
    parts = _all_gather(g, xs)                      # (R, ...)
    dim = dim % xs.dim()
    return parts.movedim(0, dim).flatten(dim, dim + 1)


def gather_along(g: EPGroup | None, x: torch.Tensor, dim: int, *,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """Every rank's ``x`` put together along ``dim`` (``g`` None or of one
    rank: ``x``); under a gradient its backward reduce-scatters the
    cotangent along ``dim``.  ``out``: a tensor of the whole shape to
    write into (a slot buffer's head), returned in place of a new one."""
    if g is None or g.size == 1:
        return x
    if _grad(x):
        return _GatherAlong.apply(g, x, dim, (out,))
    return _gather_along(g, x, dim, out)


def _gather_along(g, x, dim, out=None):
    whole = _unshard(g, x.contiguous(), dim)
    if out is None:
        return whole.contiguous()
    out.copy_(whole)
    return out


def scatter_along(g: EPGroup | None, x: torch.Tensor,
                  dim: int) -> torch.Tensor:
    """This rank's slice along ``dim`` of the sum over ranks of ``x``
    (``g`` None: ``x``); under a gradient its backward all-gathers the
    slices' cotangents along ``dim``."""
    if g is None or g.size == 1:
        return x
    if x.shape[dim] % g.size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {g.size} ranks")
    if _grad(x):
        return _ScatterAlong.apply(g, x, dim)
    return _scatter_along(g, x, dim)


def _scatter_along(g, x, dim):
    dim = dim % x.dim()
    n = x.shape[dim] // g.size
    parts = x.unflatten(dim, (g.size, n)).movedim(dim, 0)
    return _reduce_scatter(g, parts.contiguous())


def sum_grad(g: EPGroup | None, x: torch.Tensor) -> torch.Tensor:
    """``x`` itself; under a gradient its backward all-reduces the
    cotangent over ``g`` (the dual of :func:`all_reduce`)."""
    if g is None or g.size == 1 or not _grad(x):
        return x
    return _SumGrad.apply(g, x)


def reduce_whole(g: EPGroup | None, x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of the partial sums ``x``, whole on every rank
    (``g`` None or of one rank: ``x``); under a gradient its backward
    all-reduces the cotangent (see the module's notes)."""
    if g is None or g.size == 1:
        return x
    if _grad(x):
        return _ReduceWhole.apply(g, x)
    return _all_reduce(g, x)


def first_copy(g: EPGroup | None, x: torch.Tensor) -> torch.Tensor:
    """Group rank 0's ``x`` on every rank (``g`` None or of one rank:
    ``x``), as a new tensor; under a gradient its backward gives every
    rank's own ``x`` the group's mean of the cotangent (see the module's
    notes)."""
    if g is None or g.size == 1:
        return x
    if _grad(x):
        return _FirstCopy.apply(g, x)
    return broadcast(g, x.detach().clone(memory_format=torch.contiguous_format), 0)


def barrier(g: EPGroup) -> None:
    dist.barrier(group=g.group)


def broadcast(g: EPGroup, x: torch.Tensor, src: int) -> torch.Tensor:
    """``x`` of group rank ``src`` written into every rank's ``x``."""
    _count("broadcast", x)
    dist.broadcast(x, group_src=src, group=g.group)
    return x


def sendrecv(g: EPGroup, x: torch.Tensor | None, dst: int | None,
             out: torch.Tensor | None, src: int | None) -> None:
    """Point-to-point, no gradient: send ``x`` to group rank ``dst`` and
    receive group rank ``src``'s into ``out`` (either side may be None),
    posted together (``batch_isend_irecv``) so a chain of ranks cannot
    deadlock."""
    ops = []
    if x is not None:
        ops.append(dist.P2POp(dist.isend, x.contiguous(),
                              dist.get_global_rank(g.group, dst)
                              if g.group is not None else dst, g.group))
    if out is not None:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(g.group, src)
                              if g.group is not None else src, g.group))
    _count("sendrecv", x)
    for req in dist.batch_isend_irecv(ops) if ops else ():
        req.wait()


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
    _count("all_to_all", buf)
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


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, x):
        ctx.g = g
        return _all_gather(g, x)

    @staticmethod
    def backward(ctx, dy):
        return None, dy[ctx.g.rank]


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, x, dim):
        ctx.g, ctx.dim = g, dim
        return _shard(g, x, dim)

    @staticmethod
    def backward(ctx, dy):
        return None, _unshard(ctx.g, dy.contiguous(), ctx.dim), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, x):
        return _all_reduce(g, x)

    @staticmethod
    def backward(ctx, dy):
        return None, dy


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, x, dim, out):
        ctx.g, ctx.dim = g, dim
        return _gather_along(g, x, dim, out[0])

    @staticmethod
    def backward(ctx, dy):
        return None, _scatter_along(ctx.g, dy, ctx.dim), None, None


class _ScatterAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, x, dim):
        ctx.g, ctx.dim = g, dim
        return _scatter_along(g, x, dim)

    @staticmethod
    def backward(ctx, dy):
        return None, _unshard(ctx.g, dy.contiguous(), ctx.dim), None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, x):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return None, _all_reduce(ctx.g, dy)


class _ReduceWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, x):
        ctx.g = g
        return _all_reduce(g, x)

    @staticmethod
    def backward(ctx, dy):
        return None, _all_reduce(ctx.g, dy)


class _FirstCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, x):
        ctx.g = g
        return broadcast(g, x.clone(memory_format=torch.contiguous_format),
                         0)

    @staticmethod
    def backward(ctx, dy):
        return None, _all_reduce(ctx.g, dy) / ctx.g.size
