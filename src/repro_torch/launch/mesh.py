"""Meshes of ranks over ``torch.distributed``.

Mirrors ``repro.launch.mesh``: :func:`make_test_mesh` (data x model),
:func:`make_rack_mesh` (data x rack x lane) and :func:`pctx_for_mesh`.
Where the JAX mesh is an array of devices with named axes, a
:class:`Mesh` here holds the process groups of one world of ranks, in the
reference's row-major order: global rank ``d * R + r`` is data row ``d``,
EP rank ``r`` (on a rack mesh ``r = g * lanes + l``, rack-major, so flat
and factored meshes number their EP ranks alike).

The groups are built on every rank, all of them and in one order
(``torch.distributed.new_group`` is collective over the default group,
see ``repro_torch.parallel.collectives``): the mesh's world (unless it is
the default group), one EP group per data row (factored into racks x
lanes on a rack mesh), then one data group per EP rank.  A mesh takes the
first ``prod(shape)`` ranks of the default group; a rank past them gets
None.  The default group must be started first (``collectives.init``).
"""

from __future__ import annotations

import dataclasses

from repro_torch.parallel import collectives

__all__ = ["Mesh", "make_test_mesh", "make_rack_mesh", "pctx_for_mesh"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a mesh: its shape and axis names, and the
    groups it is in (``model``: the EP group; ``data``: the ranks that
    hold the same experts, one a data row; ``world``: every rank)."""

    shape: dict
    axis_names: tuple
    world: object
    model: object
    data: object


def _mesh(data: int, racks: int, lanes: int, axes: tuple) -> Mesh | None:
    W = collectives.world_size()
    R = racks * lanes
    n = data * R
    if W < n:
        raise RuntimeError(f"mesh of {n} ranks, the world has {W}")
    me = collectives.world_rank()
    world = (collectives.subgroup(list(range(n))) if n < W
             else collectives.EPGroup())
    model = None
    for d in range(data):
        row = list(range(d * R, (d + 1) * R))
        if racks > 1:
            g = collectives.factor(racks, row)
        elif data > 1 or n < W:
            g = collectives.subgroup(row)
        else:
            g = world
        if me in row:
            model = g
    data_g = None
    if data > 1:
        for r in range(R):
            g = collectives.subgroup([d * R + r for d in range(data)])
            if me % R == r and me < n:
                data_g = g
    if me >= n:
        return None
    sizes = dict(zip(axes, (data, racks, lanes) if len(axes) == 3
                     else (data, lanes)))
    return Mesh(shape=sizes, axis_names=axes, world=world, model=model,
                data=data_g)


def make_rack_mesh(data: int = 1, racks: int = 2, lanes: int = 4
                   ) -> Mesh | None:
    """Factored two-level EP mesh: (data, rack, model) = DP x scale-out x
    scale-up; the EP group is ``racks * lanes`` ranks, rack-major."""
    return _mesh(data, racks, lanes, ("data", "rack", "model"))


def make_test_mesh(data: int = 2, model: int = 4) -> Mesh | None:
    """(data, model) mesh of ``data * model`` ranks."""
    return _mesh(data, 1, model, ("data", "model"))


def pctx_for_mesh(mesh: Mesh | None):
    """The mesh's :class:`repro_torch.models.transformer.ParallelCtx`
    (one rank's: ``ParallelCtx()``, for None)."""
    from repro_torch.models.transformer import ParallelCtx

    if mesh is None:
        return ParallelCtx()
    model = mesh.model if mesh.model.size > 1 else None
    data = mesh.data
    world = mesh.world
    if (model is None) != (data is None):     # one group is the mesh
        world = None
    return ParallelCtx(group=model, data=data, world=world)
