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
are ``core.sharded.general_lane``'s, over a ``core.sharded.ShardRecord``
of the placed blocks; here they read the int16 blocks widened, and a shard
owns every local row below ``v_loc``, as in the reference.  The
sketch is one ``ops.sketch_batch`` call (the fused kernel on the card).
"""
from __future__ import annotations

import numpy as np
import torch

from .distributed import partition_graph
from .graph import INF, Graph
from .labelling import LabellingScheme
from .mesh import Mesh, resolve_mesh
from .sharded import general_lane, shard_record

INF16 = np.int16(30_000)


def _widen16(a: torch.Tensor) -> torch.Tensor:
    return torch.where(a >= int(INF16), INF, a.to(torch.int32))


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


def scale_serve(graph: Graph, scheme: LabellingScheme, mesh, us, vs, *,
                max_levels: int = 32, max_chain: int = 8):
    """Run the vertex-sharded general lane on a graph.  ``mesh`` is a
    ``core.mesh.Mesh``, a device count or ``None`` (every CUDA device; raises
    without one).  There is no index, so each call makes the shard record,
    and with it the attach's plan, from the blocks it places.  Returns (the
    set of undirected SPG edges per query, the dist array)."""
    mesh = resolve_mesh(mesh)
    n_shards = mesh.n_shards
    part, labels_sh, lsrc = build_scale_inputs(graph, scheme, mesh)
    us = np.asarray(us, np.int32)
    d0 = mesh.devices[0]
    src_sh, dst_sh = mesh.shard(part.src), mesh.shard(part.dst_local)
    labels16, lsrc16 = mesh.shard(labels_sh), mesh.shard(lsrc)
    record = shard_record(
        mesh, src_sh, dst_sh, part.vstart, [part.v_loc] * n_shards, part.v_loc,
        mesh.replicate(scheme.landmarks.to(torch.int32)),
        n_vertices=graph.n_vertices, n_edges=graph.n_edges,
        max_levels=max_levels, max_chain=max_chain)
    masks, dist = general_lane(
        record, [_widen16(t) for t in labels16], [_widen16(t) for t in lsrc16],
        scheme.meta_w.to(d0).to(torch.int32), scheme.meta_dist.to(d0).to(torch.int32),
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
