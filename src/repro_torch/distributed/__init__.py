"""Explicit collectives for the data-parallel gradient reduce, over a
``core.mesh.Mesh``.  Counterpart of ``repro.distributed`` (its sharding
rules, ``sharding.py``, are not ported yet)."""
from .collectives import all_gather_params, psum_bf16, psum_int8_ef, zero1_update

__all__ = ["all_gather_params", "psum_bf16", "psum_int8_ef", "zero1_update"]
