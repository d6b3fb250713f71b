"""The kernel dispatch seam.  Counterpart of ``repro.kernels.ops``.

The device of the tensors decides, and there is no ``use_pallas`` switch:

* a CUDA tensor launches the hand-written kernel (``minplus.minplus_cuda``,
  ``sketch.sketch_batch_cuda``, ``frontier.bitmap_expand_packed_cuda``,
  ``frontier.bitmap_expand_cuda``, ``frontier.hybrid_relay_cuda``,
  ``attach.side_attach_cuda``, ``attach_sharded.sharded_attach_cuda``) or
  raises: no ``try`` that falls back, no path that goes on running on the
  CPU;
* a CPU tensor takes the kernel's plain PyTorch version (``ref``).

That is the reference's ``use_pallas=True`` on a TPU (kernel) and its
plain ``jnp`` path elsewhere.  ``LAUNCHES`` counts kernel launches per
kernel; the plain versions never move it.
"""
from __future__ import annotations

import torch

from . import ref
from ._build import LAUNCHES
from .attach import check_side_attach_args, side_attach_cuda
from .frontier import (
    bitmap_expand_cuda,
    bitmap_expand_packed_cuda,
    check_dense_expand_args,
    check_expand_args,
    check_relay_args,
    hybrid_relay_cuda,
)
from .minplus import check_minplus_args, minplus_cuda
from .attach_sharded import (
    AttachInputs,
    AttachPlan,
    check_sharded_attach_args,
    sharded_attach_cuda,
)
from .sketch import check_sketch_args, sketch_batch_cuda

__all__ = ["LAUNCHES", "bitmap_expand", "bitmap_expand_packed", "hybrid_relay",
           "minplus", "reset_launches", "sharded_attach", "side_attach",
           "sketch_batch", "sketch_d_top"]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cuda(*tensors: torch.Tensor) -> bool:
    if all(t.device.type == "cpu" for t in tensors):
        return False
    if all(t.is_cuda for t in tensors):
        return True
    raise ValueError(f"tensors on mixed or unsupported devices: "
                     f"{[str(t.device) for t in tensors]}")


def minplus(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Tropical product C = A (min, +) B: (M, K) x (K, N) -> (M, N)."""
    if _on_cuda(a, b):
        return minplus_cuda(a, b)
    check_minplus_args(a, b)
    return ref.minplus_ref(a, b)


def bitmap_expand(frontier: torch.Tensor,
                  adjacency: torch.Tensor) -> torch.Tensor:
    """One frontier expansion over a dense adjacency block:
    (R, V) bool x (V, W) bool -> (R, W) bool."""
    if _on_cuda(frontier, adjacency):
        return bitmap_expand_cuda(frontier, adjacency)
    check_dense_expand_args(frontier, adjacency)
    return ref.bitmap_expand_ref(frontier, adjacency)


def bitmap_expand_packed(frontier: torch.Tensor, adj_words: torch.Tensor, *,
                         n_cols: int) -> torch.Tensor:
    """One frontier expansion over a bit-packed adjacency block:
    (K, V) bool x (V, ceil(n_cols / 32)) int32 words -> (K, n_cols) bool."""
    if _on_cuda(frontier, adj_words):
        return bitmap_expand_packed_cuda(frontier, adj_words, n_cols)
    check_expand_args(frontier, adj_words, n_cols)
    return ref.bitmap_expand_packed_ref(frontier, adj_words, n_cols)


def hybrid_relay(f: torch.Tensor, tail_ptr: torch.Tensor,
                 tail_col: torch.Tensor, hub_ids: torch.Tensor,
                 adj_words: torch.Tensor) -> torch.Tensor:
    """The hybrid relay, (K, V) bool -> (K, V) bool: the tail's CSR pull
    ORed with the hub block's expansion (``core.frontier.make_relay`` builds
    the arrays)."""
    if _on_cuda(f, tail_ptr, tail_col, hub_ids, adj_words):
        return hybrid_relay_cuda(f, tail_ptr, tail_col, hub_ids, adj_words)
    check_relay_args(f, tail_ptr, tail_col, hub_ids, adj_words)
    return ref.hybrid_relay_ref(f, tail_ptr, tail_col, hub_ids, adj_words)


def side_attach(depth: torch.Tensor, side_land: torch.Tensor,
                label_dist: torch.Tensor, indptr: torch.Tensor,
                src: torch.Tensor, dst: torch.Tensor, lid: torch.Tensor,
                max_chain: int, out: torch.Tensor | None = None):
    """One side of the recover search's attach (``core.search._side_attach``):
    depth ``(B, V)`` and sigma rows ``(B, R)`` over the packed labels, the
    graph's CSR and ``lid`` -> ``(edge_mask (B, E) bool, on (V, ceil(B /
    32), R) int32 words)``; with ``out`` the edges are ORed into it."""
    tensors = (depth, side_land, label_dist, indptr, src, dst, lid) \
        + (() if out is None else (out,))
    if _on_cuda(*tensors):
        return side_attach_cuda(depth, side_land, label_dist, indptr, src, dst,
                                lid, max_chain, out)
    check_side_attach_args(depth, side_land, label_dist, indptr, src, dst, lid,
                           max_chain, out)
    return ref.side_attach_ref(depth, side_land, label_dist, indptr, src, dst,
                               lid, max_chain, out)


def sharded_attach(mesh, halo, plan: AttachPlan, inp: AttachInputs,
                   max_chain: int) -> list:
    """Phase E1 of the sharded general lane (``core.sharded.general_lane``):
    every landmark's side attachments and anchor chains for both sides of a
    chunk over the mesh's shards, exchanging through ``halo`` -> each
    shard's ``(B, E)`` bool certified edges.  ``plan`` is what the kernels
    read of the index (``attach_sharded.make_attach_plan``); the plain
    version reads ``inp`` alone."""
    if _on_cuda(*inp.sides, *inp.label_src):
        return sharded_attach_cuda(mesh, halo, plan, inp, max_chain)
    check_sharded_attach_args(plan, inp, max_chain)
    return ref.sharded_attach_ref(mesh, halo, inp, max_chain)


def sketch_batch(lu: torch.Tensor, lv: torch.Tensor, meta_w: torch.Tensor,
                 meta_dist: torch.Tensor):
    """The sketches of a query batch, rows ``(B, R)`` packed or int32:
    ``(d_top, du_land, dv_land, meta_edge, d_star_u, d_star_v)`` in the
    order of ``core.sketch.SketchBatch``."""
    if _on_cuda(lu, lv, meta_w, meta_dist):
        return sketch_batch_cuda(lu, lv, meta_w, meta_dist)
    check_sketch_args(lu, lv, meta_w, meta_dist)
    return ref.sketch_batch_ref(lu, lv, meta_w, meta_dist)


def sketch_d_top(lu: torch.Tensor, lv: torch.Tensor,
                 meta_dist: torch.Tensor) -> torch.Tensor:
    """d_top for a query batch: min_r (minplus(lu, meta_dist) + lv), on
    int32 rows (widen packed tables first)."""
    t = minplus(lu, meta_dist)          # (B, R)
    return (t + lv).amin(dim=1)
