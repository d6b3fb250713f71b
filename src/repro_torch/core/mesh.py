"""A device mesh for one controller process, and its collectives.

Counterpart of ``jax.sharding.Mesh`` plus the ``lax`` collectives that the
reference's ``shard_map`` programs use (``all_gather``, ``all_to_all``,
``psum``, ``psum_scatter``, ``pmin``, ``pmax``).  The reference is
single-process SPMD; so is the port: one Python process holds a ``Mesh``,
an ordered list of S ``torch.device``s, keeps shard ``s``'s tensors on
``mesh.devices[s]``, runs each ``shard_map`` body as a loop over the
shards, and calls these functions where the body calls a collective.  A
per-shard value is a list of S tensors, one per device.

On distinct GPUs a collective is peer copies and a reduction on the
destination.  Copies and kernel launches are asynchronous, so the shards'
work on distinct devices overlaps only up to the next host wait: in the
sharded lanes (``core.sharded``) that is the reduced stop test, once per
level; the batch-sharded serve step (``core.distributed.make_serve_step``)
waits on the host at every level of each shard's search, so its shards run
one after another.  A mesh may repeat a device (``Mesh(["cpu"] * 4)``, or four shards
on one card): that is how S > 1 runs on one device, as the reference runs
it with ``--xla_force_host_platform_device_count``.

Every collective returns fresh tensors: ``t.to(d)`` returns ``t`` itself
when ``t`` already lies on ``d``, so without the copies an in-place write
into one shard's gathered or reduced value would reach another shard's
state (or the input).
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Sequence

import numpy as np
import torch


class Mesh:
    """An ordered list of devices, one per shard."""

    def __init__(self, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"

    # -- placement -----------------------------------------------------------

    def shard(self, blocks) -> list[torch.Tensor]:
        """Host ``(S, ...)`` blocks -> one tensor per shard, block ``s`` on
        ``devices[s]``."""
        return [torch.as_tensor(np.ascontiguousarray(b)).to(d)
                for b, d in zip(blocks, self.devices)]

    def replicate(self, x: torch.Tensor) -> list[torch.Tensor]:
        """One fresh copy of ``x`` per shard."""
        return [_copy(x, d) for d in self.devices]

    # -- collectives over per-shard lists -----------------------------------

    def all_gather(self, xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """``lax.all_gather(x, tiled=False)``: every shard gets the ``(S, ...)``
        stack of all shards' values."""
        return [_stack([_to(x, d) for x in xs]) for d in self.devices]

    def all_to_all(self, xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """``lax.all_to_all(x, split_axis=0, concat_axis=0, tiled=True)`` on
        ``(S, ...)`` send buffers: shard ``j`` receives ``stack_i xs[i][j]``."""
        return [_stack([_to(x[j], d) for x in xs])
                for j, d in enumerate(self.devices)]

    def psum(self, xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        return self._reduce(xs, torch.add)

    def psum_scatter(self, xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """``lax.psum_scatter(x, tiled=True)``: shard ``s`` gets block ``s``
        of the sum, the leading axis cut into S equal blocks (S must divide
        it); summed on ``devices[s]`` in shard order, as ``psum`` sums."""
        n = self.n_shards
        if xs[0].shape[0] % n:
            raise ValueError(f"a leading axis of {xs[0].shape[0]} does not split "
                             f"into {n} shards")
        out = []
        for s, d in enumerate(self.devices):
            parts = [x.reshape(n, -1, *x.shape[1:])[s] for x in xs]
            acc = _copy(parts[0], d)
            for part in parts[1:]:
                acc = acc + _to(part, d)
            out.append(acc)
        return out

    def pmin(self, xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        return self._reduce(xs, torch.minimum)

    def pmax(self, xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        return self._reduce(xs, torch.maximum)

    def _reduce(self, xs, op) -> list[torch.Tensor]:
        """Reduce on the first device, then one fresh copy per shard."""
        d0 = self.devices[0]
        acc = _copy(xs[0], d0)
        for x in xs[1:]:
            acc = op(acc, _to(x, d0))
        return [acc] + [_copy(acc, d) for d in self.devices[1:]]


def on_device(device: torch.device):
    """Make ``device`` current for the block where it is a CUDA device: the
    hand-written kernels launch on the current device's stream."""
    return torch.cuda.device(device) if device.type == "cuda" else nullcontext()


def _to(x: torch.Tensor, device: torch.device, copy: bool = False) -> torch.Tensor:
    """``x`` on ``device``; asynchronous only toward a CUDA device (a copy
    to the host must have landed before the host reads it).  uint16 moves as
    its int16 view, which holds the same bits (CUDA has few uint16 kernels)."""
    if x.dtype == torch.uint16:
        return _to(x.view(torch.int16), device, copy).view(torch.uint16)
    return x.to(device, non_blocking=device.type == "cuda", copy=copy)


def _copy(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    return _to(x, device, copy=True)


def _stack(parts: list[torch.Tensor]) -> torch.Tensor:
    """``torch.stack`` (always a new tensor), uint16 through its int16 view."""
    if parts[0].dtype == torch.uint16:
        return torch.stack([p.view(torch.int16) for p in parts]).view(torch.uint16)
    return torch.stack(parts)


def resolve_mesh(mesh=None) -> Mesh:
    """The mesh an entry point runs on: a ``Mesh`` as given; an int N, the
    first N CUDA devices (``ValueError`` when fewer are visible); ``None``,
    every CUDA device.  Like ``graph.resolve_device``, it never shrinks the
    mesh or falls back to the CPU: without a CUDA device it raises."""
    if isinstance(mesh, Mesh):
        return mesh
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass a Mesh of CPU devices (for "
            "example Mesh(['cpu'] * 4)) to run the plain PyTorch path on the "
            "host")
    n_visible = torch.cuda.device_count()
    n = n_visible if mesh is None else int(mesh)
    if n < 1 or n_visible < n:
        raise ValueError(f"mesh={n} devices requested, {n_visible} visible")
    return Mesh([torch.device("cuda", i) for i in range(n)])
