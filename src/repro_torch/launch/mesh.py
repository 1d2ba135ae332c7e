"""Meshes of ranks over ``torch.distributed``.

Mirrors ``repro.launch.mesh``: :func:`make_production_mesh` (the 16 x 16
pod, the 2 x 16 x 16 multi-pod and the factored rack mesh),
:func:`make_test_mesh` (data x model), :func:`make_rack_mesh` (data x
rack x lane) and :func:`pctx_for_mesh`.  ``pod`` and ``data`` are the
batch axes: their ranks form one data group, pod-major (the reference's
``("pod", "data")`` entry).
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

__all__ = ["Mesh", "production_shape", "make_production_mesh",
           "make_test_mesh", "make_rack_mesh", "make_serve_mesh",
           "pctx_for_mesh"]


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


def _mesh(shape: tuple, axes: tuple) -> Mesh | None:
    sizes = dict(zip(axes, shape))
    data = 1
    for a in axes:
        if a not in ("rack", "model"):
            data *= sizes[a]
    racks, lanes = sizes.get("rack", 1), sizes["model"]
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
    return Mesh(shape=sizes, axis_names=tuple(axes), world=world,
                model=model, data=data_g)


def production_shape(*, multi_pod: bool = False, racks: int = 1):
    """(shape, axis names) of :func:`make_production_mesh`'s mesh."""
    if racks > 1:
        if 16 % racks != 0:
            raise ValueError(f"racks={racks} must divide the 16-way model "
                             "axis")
        shape, axes = (16, racks, 16 // racks), ("data", "rack", "model")
        if multi_pod:
            shape, axes = (2, *shape), ("pod", *axes)
        return shape, axes
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, racks: int = 1
                         ) -> Mesh | None:
    """The 256-rank pod mesh (data 16 x model 16), or with ``multi_pod``
    512 ranks (pod 2 x data 16 x model 16); ``racks > 1`` factors the
    16-way model axis into a two-level (rack, model) EP topology."""
    return _mesh(*production_shape(multi_pod=multi_pod, racks=racks))


def make_rack_mesh(data: int = 1, racks: int = 2, lanes: int = 4
                   ) -> Mesh | None:
    """Factored two-level EP mesh: (data, rack, model) = DP x scale-out x
    scale-up; the EP group is ``racks * lanes`` ranks, rack-major."""
    return _mesh((data, racks, lanes), ("data", "rack", "model"))


def make_test_mesh(data: int = 2, model: int = 4) -> Mesh | None:
    """(data, model) mesh of ``data * model`` ranks."""
    return _mesh((data, model), ("data", "model"))


def make_serve_mesh(model: int, racks: int = 1) -> Mesh | None:
    """The serve CLI's mesh: one data row, ``model`` EP ranks, factored
    into ``racks`` x ``model / racks`` with ``racks > 1``."""
    if racks > 1:
        if model % racks:
            raise ValueError(f"racks={racks} must divide the {model} ranks")
        return make_rack_mesh(1, racks, model // racks)
    return make_test_mesh(1, model)


def pctx_for_mesh(mesh: Mesh | None):
    """The mesh's :class:`repro_torch.models.transformer.ParallelCtx`
    (one rank's: ``ParallelCtx()``, for None), carrying its axis sizes:
    the model takes the reference's layout on it
    (``repro_torch.parallel.sharding``) for every step."""
    from repro_torch.models.transformer import ParallelCtx

    if mesh is None:
        return ParallelCtx()
    model = mesh.model if mesh.model.size > 1 else None
    data = mesh.data
    world = mesh.world
    if (model is None) != (data is None):     # one group is the mesh
        world = None
    return ParallelCtx(group=model, data=data, world=world,
                       mesh_axes=tuple(mesh.shape.items()))
