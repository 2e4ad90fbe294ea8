"""The process mesh: five named axes over the ranks of a process group.

The JAX package lays its devices out as a ``jax.sharding.Mesh`` with the
axes ``data`` (data parallelism), ``model`` (tensor parallelism), ``pipe``
(pipeline stages), ``context`` (sequence parallelism) and ``expert``
(expert parallelism), and its collectives name an axis. Here a rank is a
process, the mesh is the world's ranks laid out row-major over the same
five axes (rank = the flat index of its coordinates, as ``np.reshape``
lays out the JAX device array), and each axis is a
``torch.distributed`` process group: for every axis, the ranks that differ
only in that axis's coordinate form one group. ``collectives.py`` resolves
an axis name against the mesh that is active (``with mesh:``) or passed.

A tuple of axes, ``("data", "expert")``, is one joint axis (the JAX
package's ``psum(x, ("data", "expert"))``): its size is the product, a
rank's index the row-major index of its coordinates in the tuple's order,
and its group the ranks that differ only in those coordinates. Its groups
are made the first time a rank asks for it, on every rank (a collective
is called by every rank in the same order, so the ranks make them
together); a joint axis with at most one axis above size 1 reuses that
axis's group.

The groups are made with ``dist.new_group``, one per (axis, slice), and
not with ``torch.distributed.device_mesh.init_device_mesh``: with
``device_type="cuda"`` that call sets each process's current card to
``LOCAL_RANK`` itself, which is ``cuda:1`` and up for the second and later
ranks on a machine with one card (the layout ``chip_smoke.py`` runs, four
ranks time-sharing ``cuda:0``), and the call then fails; it also makes a
group for every axis of size 1, which no collective needs. The backend of
each group is the default group's (``core/dist.py`` picks it).

The multislice helpers of the JAX module (``num_slices``,
``hybrid_device_array``) come with multislice (ROADMAP Queue 1 item 14).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any

import numpy as np

AXES = ("data", "model", "pipe", "context", "expert")

# the meshes entered with ``with mesh:``, innermost last; process-wide and
# not thread-local, because autograd runs a CUDA backward on its own thread
_ACTIVE: list["Mesh"] = []


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape. ``-1`` means "fill with the remaining ranks"."""

    data: int = -1
    model: int = 1
    pipe: int = 1
    context: int = 1
    expert: int = 1

    def resolve(self, n_ranks: int) -> dict[str, int]:
        """Resolve a -1 entry against the rank count; validate the
        product."""
        sizes = {a: getattr(self, a) for a in AXES}
        for a, s in sizes.items():
            if s != -1 and s < 1:
                raise ValueError(f"axis {a!r} size must be -1 or >= 1, "
                                 f"got {s}")
        fills = [a for a, s in sizes.items() if s == -1]
        if len(fills) > 1:
            raise ValueError(f"at most one axis may be -1, got {fills}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if fills:
            if n_ranks % fixed:
                raise ValueError(f"{n_ranks} ranks not divisible by fixed "
                                 f"axes product {fixed}")
            sizes[fills[0]] = n_ranks // fixed
        if math.prod(sizes.values()) != n_ranks:
            raise ValueError(f"mesh {sizes} needs {math.prod(sizes.values())}"
                             f" ranks, have {n_ranks}")
        return sizes


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """One axis as this rank sees it: its size, this rank's index along
    it, the global ranks of its group in axis order, and the process group
    (``None`` for an axis of size 1, which needs no communication)."""

    name: str
    size: int
    index: int
    ranks: tuple[int, ...]
    group: Any = None


class Mesh:
    """The five axes of one rank: sizes, coordinates and process groups."""

    def __init__(self, sizes: dict[str, int], rank: int,
                 axes: dict[str, AxisGroup]):
        self.sizes = dict(sizes)
        self.rank = rank
        self._axes = axes
        self._joint: dict[tuple[str, ...], AxisGroup] = {}

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.sizes[a] for a in AXES)

    def axis(self, name: "str | tuple[str, ...]") -> AxisGroup:
        if isinstance(name, (tuple, list)):
            return self._joint_axis(tuple(name))
        if name not in self._axes:
            raise ValueError(f"unknown mesh axis {name!r} (one of {AXES})")
        return self._axes[name]

    def _joint_axis(self, names: tuple[str, ...]) -> AxisGroup:
        if len(names) == 1:
            return self.axis(names[0])
        hit = self._joint.get(names)
        if hit is not None:
            return hit
        if len(set(names)) != len(names):
            raise ValueError(f"mesh axes {names} repeat an axis")
        parts = [self.axis(n) for n in names]
        size = math.prod(p.size for p in parts)
        index = int(np.ravel_multi_index([p.index for p in parts],
                                         [p.size for p in parts]))
        live = [p for p in parts if p.size > 1]
        if len(live) <= 1:
            ranks = live[0].ranks if live else (self.rank,)
            group = live[0].group if live else None
        else:
            import torch.distributed as dist

            shape = tuple(self.sizes[a] for a in AXES)
            ranks = group = None
            for members in _axes_ranks(shape, [AXES.index(n)
                                               for n in names]):
                made = dist.new_group(list(members))
                if self.rank in members:
                    ranks, group = members, made
        joint = AxisGroup(",".join(names), size, index, ranks, group)
        self._joint[names] = joint
        return joint

    def __enter__(self) -> "Mesh":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)


def current_mesh() -> Mesh:
    """The innermost mesh entered with ``with mesh:``."""
    if not _ACTIVE:
        raise RuntimeError("no active mesh: pass mesh= or enter one with "
                           "`with mesh:`")
    return _ACTIVE[-1]


def resolve_axis(axis: "str | tuple[str, ...] | AxisGroup",
                 mesh: Mesh | None = None) -> AxisGroup:
    """An axis name (or a tuple of them, one joint axis) against ``mesh``
    (or the active mesh); an ``AxisGroup`` is taken as it is."""
    if isinstance(axis, AxisGroup):
        return axis
    return (mesh if mesh is not None else current_mesh()).axis(axis)


def _axes_ranks(shape: tuple[int, ...], axes: list[int]):
    """Every group of the joint axis ``axes`` (dims of ``shape``): for
    each choice of the other coordinates, the flat ranks over ``axes``,
    row-major in their order. The same order on every rank, so that every
    rank makes the same groups in the same sequence."""
    others = [range(n) if i not in axes else [None]
              for i, n in enumerate(shape)]
    for fixed in itertools.product(*others):
        group = []
        for inner in itertools.product(*(range(shape[a]) for a in axes)):
            c = list(fixed)
            for a, j in zip(axes, inner):
                c[a] = j
            group.append(int(np.ravel_multi_index(c, shape)))
        yield tuple(group)


def build_mesh(spec: MeshSpec | None = None) -> Mesh:
    """The mesh of this rank over the default process group's ranks (one
    rank when no group is initialised). Every rank of the group must call
    it, with the same ``spec``: each axis's groups are made collectively."""
    import torch.distributed as dist

    spec = spec or MeshSpec()
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    sizes = spec.resolve(world)
    shape = tuple(sizes[a] for a in AXES)
    coords = np.unravel_index(rank, shape)
    axes = {}
    for i, name in enumerate(AXES):
        mine = None
        for ranks in _axes_ranks(shape, [i]):
            group = dist.new_group(list(ranks)) if len(ranks) > 1 else None
            if rank in ranks:
                mine = (ranks, group)
        axes[name] = AxisGroup(name, shape[i], int(coords[i]), mine[0],
                               mine[1])
    return Mesh(sizes, rank, axes)


def single_device_mesh() -> Mesh:
    """An all-ones mesh of one rank: the single-process control."""
    return Mesh({a: 1 for a in AXES}, 0,
                {a: AxisGroup(a, 1, 0, (0,)) for a in AXES})


def axis_sizes(mesh: Mesh) -> dict[str, int]:
    return dict(mesh.sizes)
