"""Production and test meshes as names and sizes (port of
`repro.launch.mesh`).

Every mesh here is an :class:`~repro_torch.parallel.sharding.AbstractMesh`:
axis names and sizes, no devices and no process group, so building one
touches no card.  The rule tables (`parallel.sharding`) and the dry run
(`launch.dryrun`) resolve against them.  A mesh that runs collectives is
``parallel.data_mesh``.
"""
from __future__ import annotations

import math

from ..parallel.sharding import AbstractMesh, abstract_mesh

__all__ = ["make_production_mesh", "make_test_mesh", "mesh_device_count"]


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16 x 16 ("data", "model"), or 2 x 16 x 16 ("pod", "data", "model"):
    the reference's production shapes; "pod" is an outer pure data-parallel
    axis."""
    if multi_pod:
        return abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    return abstract_mesh((16, 16), ("data", "model"))


def make_test_mesh(data: int = 4, model: int = 2) -> AbstractMesh:
    """A small ("data", "model") mesh; ``make_test_mesh(4, 1)`` is four
    cards of pure data parallelism."""
    return abstract_mesh((data, model), ("data", "model"))


def mesh_device_count(mesh) -> int:
    """Devices of an AbstractMesh (or of a ``DeviceMesh``)."""
    if isinstance(mesh, AbstractMesh):
        return math.prod(mesh.shape)
    return mesh.size()
