"""Explicit-collective helpers for the data-parallel gradient reduce, on
the port's one-controller ``core.mesh.Mesh``.  Counterpart of
``repro.distributed.collectives``.

Each function takes the per-shard values (a list of S trees or tensors,
shard ``s``'s on ``mesh.devices[s]``, as a ``shard_map`` body sees them)
and the mesh, and returns the per-shard results; a tree is nested dicts
of tensors.

* ``psum_bf16``: the all-reduce in bf16 (2x fewer bytes), back to f32.
* ``psum_int8_ef``: int8 with a per-tensor scale (4x fewer bytes) and
  error feedback, so the quantisation error goes into the next step
  instead of the model.  The reference's formula, kept as it is: the int32
  sum of the shards' int8 values times the *mean* of their scales.
* ``zero1_update`` / ``all_gather_params``: ZeRO-1's decomposition of an
  all-reduce, a tiled reduce-scatter (each shard owns 1/S of the flat
  gradient for its optimizer shard) and a tiled all-gather.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping, Sequence

import torch

from ..core.mesh import Mesh


def _per_leaf(fn: Callable, *shard_trees: Sequence[Any]) -> list[Any]:
    """``fn(*per-shard leaf lists) -> per-shard list`` at every leaf of the
    per-shard trees; returns the per-shard trees of its results."""
    first = shard_trees[0][0]
    if isinstance(first, Mapping):
        per_key = {k: _per_leaf(fn, *([t[k] for t in ts] for ts in shard_trees))
                   for k in first}
        return [{k: per_key[k][s] for k in first} for s in range(len(shard_trees[0]))]
    return fn(*shard_trees)


def _pick(tree: Any, i: int) -> Any:
    """Item ``i`` of every tuple leaf."""
    if isinstance(tree, Mapping):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


def psum_bf16(trees: Sequence[Any], mesh: Mesh) -> list[Any]:
    def one(gs):
        red = mesh.psum([g.to(torch.bfloat16) for g in gs])
        return [r.to(torch.float32) for r in red]
    return _per_leaf(one, trees)


def _quant_int8(g: torch.Tensor):
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    return torch.round(g / scale).to(torch.int8), scale


def psum_int8_ef(trees: Sequence[Any], errors: Sequence[Any],
                 mesh: Mesh) -> tuple[list[Any], list[Any]]:
    """int8 all-reduce with error feedback: ``(reduced, new_errors)``, each
    a per-shard list of trees."""

    def one(gs, es):
        g32 = [g.to(torch.float32) + e for g, e in zip(gs, es)]
        qs, scales = zip(*(_quant_int8(g) for g in g32))
        new_e = [g - q.to(torch.float32) * sc for g, q, sc in zip(g32, qs, scales)]
        # int32 accumulators (int8 would overflow past 127 summands)
        red = mesh.psum([q.to(torch.int32) for q in qs])
        scale_sum = mesh.psum(list(scales))
        count = mesh.psum([torch.ones((), device=d) for d in mesh.devices])
        return [(r.to(torch.float32) * (ss / c), e)
                for r, ss, c, e in zip(red, scale_sum, count, new_e)]

    pairs = _per_leaf(one, trees, errors)
    return [_pick(t, 0) for t in pairs], [_pick(t, 1) for t in pairs]


def zero1_update(grads_flat: Sequence[torch.Tensor], mesh: Mesh) -> list[torch.Tensor]:
    """The tiled reduce-scatter of each shard's flat gradient vector: shard
    ``s`` gets slice ``s`` of the sum for its optimizer shard; the caller
    all-gathers the updated parameters."""
    return mesh.psum_scatter(grads_flat)


def all_gather_params(shards: Sequence[torch.Tensor], mesh: Mesh) -> list[torch.Tensor]:
    """The tiled all-gather: every shard gets the shards' slices
    concatenated along the leading axis."""
    return [x.reshape(-1, *x.shape[2:]) for x in mesh.all_gather(shards)]
