"""Vertex-sharded SPG serving for graphs too large to replicate (labels and
search state sharded over the mesh).  Counterpart of
``repro.core.scale_serve``.

Layout (per shard, S shards):
  vertices     contiguous block [vstart, vstart + v_loc), +1 garbage row
  edges        dst-owned (the ``EdgePartition`` of the distributed labelling)
  labels       labels_loc (v_loc, R) int16 (sentinel ``INF16``) plus
               *edge-aligned* source-label copies label_src (E_loc, R)
               int16: the edge-attribute trade that makes every recover
               certificate edge-local
  queries      (B,), replicated; per-query scalars reduced over all shards

The phases (label rows, sketch, bounded Bi-BFS, reverse sweeps, recover)
are ``core.sharded.general_lane``'s; here they read the int16 blocks, and
a shard owns every local row below ``v_loc``, as in the reference.  The
sketch is one ``ops.sketch_batch`` call (the fused kernel on the card).
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.attach_sharded import make_attach_plan
from .distributed import partition_graph
from .graph import INF, Graph
from .labelling import LabellingScheme
from .mesh import Mesh, resolve_mesh
from .sharded import general_lane

INF16 = np.int16(30_000)


def _widen16(a: torch.Tensor) -> torch.Tensor:
    return torch.where(a >= int(INF16), INF, a.to(torch.int32))


def make_scale_serve_step(mesh: Mesh, *, n_vertices: int, v_loc: int,
                          batch: int, max_levels: int = 32, max_chain: int = 8):
    """``step(src_sh, dst_sh, vstart, labels_sh, lsrc_sh, landmarks_sh,
    meta_w, meta_dist, us, vs)`` -> ``(per-shard (B, E_loc) edge masks, dist
    (B,))``: the masks mark each shard's dst-owned SPG edges, not
    symmetrized; ``dist`` lies on ``mesh.devices[0]``.  There is no index,
    so each call makes the attach's plan from the blocks it is handed."""

    def step(src_sh, dst_sh, vstart, labels_sh, lsrc_sh, landmarks_sh,
             meta_w, meta_dist, us, vs):
        d0 = mesh.devices[0]
        if us.shape[0] != batch:
            raise ValueError(f"step built for batch {batch}, got {us.shape[0]}")
        return general_lane(
            mesh, vstart=vstart, n_own=[v_loc] * mesh.n_shards, v_loc=v_loc,
            n_vertices=n_vertices, src_sh=src_sh, dst_sh=dst_sh,
            labels_sh=[_widen16(t) for t in labels_sh],
            label_src_sh=[_widen16(t) for t in lsrc_sh],
            landmarks_sh=landmarks_sh,
            meta_w=meta_w.to(d0).to(torch.int32),
            meta_dist=meta_dist.to(d0).to(torch.int32),
            us=us.to(d0), vs=vs.to(d0), max_levels=max_levels,
            max_chain=max_chain,
            attach_plan=make_attach_plan(src_sh, dst_sh, vstart, v_loc,
                                         landmarks_sh, n_vertices))

    return step


def build_scale_inputs(graph: Graph, scheme: LabellingScheme, mesh: Mesh):
    """Host side: partition the edges over ``mesh`` (``partition_graph``,
    as host arrays) and build the vertex-sharded and edge-aligned int16
    label arrays."""
    n_shards = mesh.n_shards
    part = partition_graph(graph, mesh).host()
    labels = scheme.label_dist.cpu().numpy()
    labels16 = np.where(labels >= INF, INF16, labels).astype(np.int16)
    v = graph.n_vertices
    r = labels.shape[1]
    vloc = part.v_loc
    vend = np.concatenate([part.vstart[1:], [v]])
    labels_sh = np.full((n_shards, vloc, r), INF16, np.int16)
    for s in range(n_shards):
        n_loc = vend[s] - part.vstart[s]
        labels_sh[s, :n_loc] = labels16[part.vstart[s]:vend[s]]
    lsrc = labels16[np.clip(part.src, 0, v - 1)]   # (S, E, R)
    return part, labels_sh, lsrc


def scale_serve(graph: Graph, scheme: LabellingScheme, mesh, us, vs, **kw):
    """Run the vertex-sharded serving step on a graph.  ``mesh`` is a
    ``core.mesh.Mesh``, a device count or ``None`` (every CUDA device; raises
    without one).  Returns (the set of undirected SPG edges per query, the
    dist array)."""
    mesh = resolve_mesh(mesh)
    n_shards = mesh.n_shards
    part, labels_sh, lsrc = build_scale_inputs(graph, scheme, mesh)
    us = np.asarray(us, np.int32)
    step = make_scale_serve_step(mesh, n_vertices=graph.n_vertices,
                                 v_loc=part.v_loc, batch=us.shape[0], **kw)
    d0 = mesh.devices[0]
    masks, dist = step(
        mesh.shard(part.src), mesh.shard(part.dst_local), part.vstart,
        mesh.shard(labels_sh), mesh.shard(lsrc),
        mesh.replicate(scheme.landmarks.to(torch.int32)),
        scheme.meta_w, scheme.meta_dist,
        torch.as_tensor(us, device=d0),
        torch.as_tensor(np.asarray(vs, np.int32), device=d0))
    dist = dist.cpu().numpy()
    pairs = [set() for _ in range(us.shape[0])]
    for s in range(n_shards):
        dst_glob = part.dst_local[s] + part.vstart[s]
        valid = part.dst_local[s] < part.v_loc
        mask_np = masks[s].cpu().numpy()
        for b in range(us.shape[0]):
            sel = mask_np[b] & valid
            for a_, c_ in zip(part.src[s][sel], dst_glob[sel]):
                pairs[b].add((int(min(a_, c_)), int(max(a_, c_))))
    return pairs, dist
