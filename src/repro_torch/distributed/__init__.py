"""Explicit collectives for the data-parallel gradient reduce over a
``core.mesh.Mesh``, and the mesh-axis conventions and partition specs
(``sharding``) that the production-mesh dry run lays tensors out with.
Counterpart of ``repro.distributed``."""
from .collectives import all_gather_params, psum_bf16, psum_int8_ef, zero1_update
from .sharding import P, dp_axes_of, local_mesh, named, shard_tree

__all__ = ["P", "all_gather_params", "dp_axes_of", "local_mesh", "named",
           "psum_bf16", "psum_int8_ef", "shard_tree", "zero1_update"]
