"""The device mesh (twin of ``repro/launch/mesh.py``) over a
``torch.distributed`` process group.

A mesh names a grid of ranks, ``shape`` over ``axes`` (the last axis is
``"model"``).  Rank ``r`` of the process group sits at the coordinates of
``r`` in the grid, first axis major, the order in which the reference's
``combined_axis_index`` numbers devices (``dist.comm.combined_axis_index``).
:func:`make_mesh` builds, on every rank and in one order, the subgroups the
hybrid step runs its collectives over (``dist.comm.Group``): one for each
axis, for all axes together, and for the axes before ``"model"`` together.
A subgroup of one rank runs its collectives locally and has no process
group.

Launching N ranks: ``torch.distributed.init_process_group`` with world size
N in each of N processes, then ``make_mesh(shape, axes, device)`` in each.
On the CPU the backend is gloo; on CUDA it is NCCL with one card a rank, or
gloo when several ranks share a card (NCCL refuses two ranks on one
device), and then every collective copies its payload through pinned host
memory (``dist.comm``).  A mesh of one rank needs no process group: without
one, its collectives are the identity and the train step is the port's
one-rank step.

A shape-only mesh (:func:`make_shape_mesh`, :func:`make_production_mesh`)
is one rank's view of a mesh of any size with no process group behind it:
its groups are ``dist.comm``'s shape-only groups, whose collectives count
their bytes and reach no backend.  It exists for the dry run
(``launch/dryrun.py``) alone: :func:`resolve_mesh` refuses it outside
:func:`shape_only_meshes`, the run loop and the server refuse it always
(:func:`refuse_shape_only`), and the launcher builds its mesh with
:func:`make_mesh`, which never makes one.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import math
import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.dist import comm


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of ranks: the axis sizes ``shape`` (axis name -> size), this
    rank's ``device``, its index ``rank`` in the grid, and the collective
    groups of :func:`make_mesh`, which share one
    :class:`comm.CollectiveStats`."""

    shape: dict
    device: torch.device
    rank: int = 0
    groups: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)
    stats: comm.CollectiveStats = dataclasses.field(default_factory=comm.CollectiveStats,
                                                    compare=False, repr=False)

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def coords(self) -> dict:
        """This rank's coordinate on each axis."""
        return dict(zip(self.shape, np.unravel_index(self.rank, tuple(self.shape.values()))))

    def group(self, axes) -> comm.Group:
        """The collective group over ``axes`` (an axis name or a tuple of
        them, in mesh order) that holds this rank."""
        axes = tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)
        if axes not in self.groups:
            raise KeyError(f"the mesh has no group over {axes}; it has {sorted(self.groups)}")
        return self.groups[axes]

    @property
    def shape_only(self) -> bool:
        """Whether the mesh's groups are shape-only (:func:`make_shape_mesh`)."""
        return any(g.shape_only for g in self.groups.values())

    @property
    def host_staging(self) -> bool:
        """Whether collectives of CUDA tensors go through host memory (a gloo
        process group on a CUDA device)."""
        return self.device.type == "cuda" and any(
            g.backend == "gloo" for g in self.groups.values())


def group_axes(axes: tuple) -> list[tuple]:
    """The axis tuples a mesh over ``axes`` builds groups for: each axis, all
    axes, and the axes before the last."""
    out = [(a,) for a in axes]
    for t in (tuple(axes), tuple(axes[:-1])):
        if t and t not in out:
            out.append(t)
    return out


def make_mesh(shape, axes, device="cuda", group=None) -> Mesh:
    """A mesh of ``shape`` over ``axes``, this rank's device ``device``.

    ``group``: the process group the mesh spans; None means the default one
    when the mesh holds more than one rank, and none for a one-rank mesh
    (whose collectives are then the identity).  The group's size must be the
    mesh's.  Every rank of the group must call this, in the same order as
    its other ``make_mesh`` and ``new_group`` calls: it creates the
    subgroups collectively."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    named = dict(zip(axes, shape))
    dev = resolve_device(device)
    n = math.prod(shape)
    if group is None and n > 1:
        if not (dist.is_available() and dist.is_initialized()):
            raise NotImplementedError(
                f"mesh {named} has {n} ranks: without a torch.distributed process group the "
                f"port runs on one rank; call init_process_group with world size {n} in each "
                "of its processes first")
        group = dist.group.WORLD
    stats = comm.CollectiveStats()
    if group is None:
        groups = {t: comm.Group(t, 1, 0, None, stats) for t in group_axes(axes)}
        return Mesh(shape=named, device=dev, groups=groups, stats=stats)
    if dist.get_world_size(group) != n:
        raise ValueError(f"mesh {named} has {n} ranks, its process group "
                         f"{dist.get_world_size(group)}")
    rank = dist.get_rank(group)
    me = dict(zip(axes, np.unravel_index(rank, shape)))
    glob = [dist.get_global_rank(group, r) if group is not dist.group.WORLD else r
            for r in range(n)]
    groups = {}
    for t in group_axes(axes):
        size = math.prod(named[a] for a in t)
        others = [a for a in axes if a not in t]
        mine = None
        if size == n:
            mine = group
        elif size > 1:
            # every rank creates every subgroup, in one order
            for fixed in itertools.product(*(range(named[a]) for a in others)):
                members = [r for r in range(n)
                           if all(np.unravel_index(r, shape)[axes.index(a)] == v
                                  for a, v in zip(others, fixed))]
                pg = dist.new_group([glob[r] for r in members])
                if rank in members:
                    mine = pg
        groups[t] = comm.Group(t, size, comm.combined_axis_index(me, t, named), mine, stats)
    return Mesh(shape=named, device=dev, rank=rank, groups=groups, stats=stats)


def make_shape_mesh(shape, axes, rank: int = 0, device="cuda") -> Mesh:
    """Rank ``rank``'s view of a mesh of ``shape`` over ``axes`` with no
    process group: every group is shape-only (``dist.comm.shape_group``),
    so a step built on it runs this rank's share of the work, and its
    collectives count their bytes, on ``device`` alone."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    named = dict(zip(axes, shape))
    n = math.prod(shape)
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} is not in a mesh of {n} ranks")
    me = dict(zip(axes, np.unravel_index(rank, shape)))
    stats = comm.CollectiveStats()
    groups = {t: comm.shape_group(t, math.prod(named[a] for a in t),
                                  comm.combined_axis_index(me, t, named), stats)
              for t in group_axes(axes)}
    return Mesh(shape=named, device=resolve_device(device), rank=rank, groups=groups, stats=stats)


def make_production_mesh(*, multi_pod: bool = False, rank: int = 0, device="cuda") -> Mesh:
    """The reference's production mesh as a shape-only mesh: 16 x 16 chips
    a pod over ``("data", "model")``, or two pods, ``(2, 16, 16)`` over
    ``("pod", "data", "model")``; this rank ``rank`` on ``device``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_shape_mesh(shape, axes, rank, device)


_SHAPE_ONLY_OK = contextvars.ContextVar("shape_only_ok", default=False)


@contextlib.contextmanager
def shape_only_meshes():
    """Inside it, :func:`resolve_mesh` takes a shape-only mesh: the dry
    run's steps are built and run there."""
    token = _SHAPE_ONLY_OK.set(True)
    try:
        yield
    finally:
        _SHAPE_ONLY_OK.reset(token)


def refuse_shape_only(mesh, what: str) -> None:
    """Raise where ``mesh`` is shape-only: ``what`` runs real ranks."""
    if isinstance(mesh, Mesh) and mesh.shape_only:
        raise ValueError(f"{what} refuses a shape-only mesh ({mesh.shape}): it has no process "
                         "group and exists for launch/dryrun.py alone")


def resolve_mesh(mesh=None, device="cuda") -> Mesh:
    """``mesh``, or where it is None the one-rank ``(1, 1)`` mesh over
    ``("data", "model")`` on ``device``, with no process group.  A
    shape-only mesh is refused outside :func:`shape_only_meshes`."""
    if mesh is None:
        return make_mesh((1, 1), ("data", "model"), device)
    if not isinstance(mesh, Mesh):
        raise TypeError(f"need a launch.mesh.Mesh, got {type(mesh).__name__}")
    if not _SHAPE_ONLY_OK.get():
        refuse_shape_only(mesh, "a step outside the dry run")
    return mesh
