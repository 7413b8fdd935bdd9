"""The port's mesh (port of ``realtime_stereo_matcher_tpu/parallel/mesh.py``).

The JAX package meshes its devices on named axes: ``data`` (the batch),
``spatial`` (image rows) and, for sharded inference, ``disp`` (the cost
volume's disparity axis), each over the first k devices
(``sharded_infer.py``: ``Mesh(dev[:k], ("spatial",))``).  Here a rank is
one process with one device, so every axis is ranks of a
``torch.distributed`` group; no rank owns two devices.

* :class:`Mesh` -- the ``data`` axis over the ranks of ``group`` (training).
* :class:`Axis` -- a ``spatial`` or ``disp`` axis over the first ``size``
  ranks of the world (:func:`prefix_axis`), with this rank's place on it.
  Its subgroup comes from :func:`prefix_groups`, which makes the subgroup
  of the first k ranks for every k at once, in every rank, because
  ``new_group`` is collective over the world.

BatchNorm statistics reduce over the global batch when a step is given the
mesh's group (sync-BN: ``models/layers.py``, ``models/fast_train.py``), as
the JAX package gets it from jit-level batch sharding.
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist

from realtime_stereo_matcher_tpu_torch.parallel.distributed import (
    default_group,
    rank_and_world,
)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``data`` axis over the ranks of ``group`` (None: one process)."""

    group: object = None

    @property
    def rank(self) -> int:
        return rank_and_world(self.group)[0]

    @property
    def size(self) -> int:
        return rank_and_world(self.group)[1]


def make_mesh(data: int | None = None) -> Mesh:
    """The mesh of the world group where this process joined one, else a
    mesh of one process.  ``data`` must be the group's size where given."""
    mesh = Mesh(default_group())
    if data is not None and data != mesh.size:
        raise ValueError(f"data axis {data} != {mesh.size} ranks")
    return mesh


def shard_batch(mesh: Mesh, arrays) -> tuple:
    """This rank's rows of each global batch array (first axis split evenly
    over the ``data`` axis, rank r the r-th block)."""
    n, r = mesh.size, mesh.rank

    def take(x):
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} not divisible by {n} ranks")
        b = x.shape[0] // n
        return x[r * b:(r + 1) * b]

    return tuple(take(x) for x in arrays)


@dataclasses.dataclass(frozen=True)
class Axis:
    """A mesh axis over the first ``size`` ranks of the world: ``group``
    their subgroup (None for one rank: no collective), ``index`` this
    rank's place on the axis, None where the rank is not on it."""

    group: object
    index: int | None
    size: int

    @property
    def member(self) -> bool:
        return self.index is not None


_PREFIX_GROUPS: dict = {}


def prefix_groups() -> dict:
    """{k: the subgroup of world ranks 0..k-1} for k = 2 .. world (the
    world group itself for k = world), made once a process.  Every rank of
    the world must make the first call together: ``new_group`` is
    collective.  Empty for one process."""
    if not dist.is_initialized():
        return {}
    world = dist.get_world_size()
    if not _PREFIX_GROUPS:
        for k in range(2, world):
            _PREFIX_GROUPS[k] = dist.new_group(list(range(k)))
        if world > 1:
            _PREFIX_GROUPS[world] = dist.group.WORLD
    return _PREFIX_GROUPS


def prefix_axis(size: int) -> Axis:
    """The axis over world ranks 0..size-1 (see :func:`prefix_groups`)."""
    rank, world = rank_and_world(default_group())
    if not 1 <= size <= world:
        raise ValueError(f"an axis of {size} ranks in a world of {world}")
    group = prefix_groups()[size] if size > 1 else None
    return Axis(group, rank if rank < size else None, size)
