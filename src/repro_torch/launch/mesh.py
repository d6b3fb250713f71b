"""Production mesh construction.  Counterpart of ``repro.launch.mesh``.

The production meshes are shapes, not machines: ``make_production_mesh``
returns a ``core.mesh.NamedMesh`` whose every shard is the meta device, so
the dry run lays out and traces a 256- or 512-device step on any host,
whatever devices it has (the reference forces 512 host devices for the
same purpose)."""
from __future__ import annotations

import numpy as np

from ..core.mesh import NamedMesh


def make_production_mesh(*, multi_pod: bool = False) -> NamedMesh:
    """(data=16, model=16), or (pod=2, data=16, model=16) with
    ``multi_pod``, over the meta device."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return NamedMesh(["meta"] * int(np.prod(shape)), axes, shape)


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(n for n in mesh.axis_names if n != "model")
