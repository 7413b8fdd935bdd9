"""The port's mesh (port of ``realtime_stereo_matcher_tpu/parallel/mesh.py``).

The JAX package meshes its devices on two axes, ``data`` (the batch) and
``spatial`` (image rows, for sharded inference).  Here a rank is one process
with one device, so the ``data`` axis is the ranks of a
``torch.distributed`` group; no rank owns two devices.  There is no
``spatial`` axis yet: it comes with sharded inference (ROADMAP.md).

BatchNorm statistics reduce over the global batch when a step is given the
mesh's group (sync-BN: ``models/layers.py``, ``models/fast_train.py``), as
the JAX package gets it from jit-level batch sharding.
"""

from __future__ import annotations

import dataclasses

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
