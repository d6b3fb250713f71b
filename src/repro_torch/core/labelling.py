"""Algorithm 2 (labelling scheme construction), batched over landmarks.
Counterpart of ``repro.core.labelling``.

All |R| landmark BFSs run as one level-synchronous program over

    depth[R, V]    BFS depth per landmark root (INF = unvisited)
    reach_L[R, V]  "a shortest path from root r exists whose interior
                    contains no landmark" (the paper's Q_L membership)

Per level one fused relay carries both messages stacked as ``(2R, V)``:
*visited* (from every frontier vertex) and *L* (only from frontier
vertices allowed as path interior: non-landmarks, or the root itself).
Under ``backend="hybrid"`` that relay is one call of the fused
``hybrid_relay`` kernel on the card (tail rows and hub block).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .frontier import FrontierEngine, make_relay
from .graph import INF, Graph, resolve_device


class LabellingScheme(NamedTuple):
    """Labelling scheme L = (M, L) of Definition 4.2 in dense form."""

    landmarks: torch.Tensor    # (R,) int32 vertex ids
    lid: torch.Tensor          # (V,) int32 vertex -> landmark index, -1 otherwise
    is_landmark: torch.Tensor  # (V,) bool
    label_dist: torch.Tensor   # (V, R) int32; INF where no label entry exists
    meta_w: torch.Tensor       # (R, R) int32 meta-graph edge weights; INF = no edge
    meta_dist: torch.Tensor    # (R, R) int32 APSP distances d_M on the meta-graph

    @property
    def n_landmarks(self) -> int:
        return int(self.landmarks.shape[0])


def _bfs_rows(engine: FrontierEngine, roots: torch.Tensor,
              is_landmark: torch.Tensor, max_levels: int):
    """Level-synchronous (depth, reach_L) BFS rows from ``roots``; rows are
    independent of one another.  One host sync per level (the loop test)."""
    k = roots.shape[0]
    v = engine.n_vertices
    dev = roots.device
    rows = torch.arange(k, device=dev)
    cols = roots.to(torch.int64)
    depth = torch.full((k, v), INF, dtype=torch.int32, device=dev)
    depth[rows, cols] = 0
    reach_l = torch.zeros((k, v), dtype=torch.bool, device=dev)
    reach_l[rows, cols] = True
    # roots may relay L-messages even though they are landmarks
    propagate_ok = (~is_landmark)[None, :].expand(k, v).clone()
    propagate_ok[rows, cols] = True

    level = 0
    alive = True
    while alive and level < max_levels:
        frontier = depth == level
        prop_l = frontier & reach_l & propagate_ok
        # one fused relay for both message kinds (rows are independent)
        msg = engine.relay(torch.cat([frontier, prop_l], dim=0))
        msg_vis, msg_l = msg[:k], msg[k:]
        new = msg_vis & (depth == INF)
        depth = torch.where(new, level + 1, depth)
        reach_l |= new & msg_l
        level += 1
        alive = bool(new.any())
    return depth, reach_l


def meta_apsp(meta_w: torch.Tensor) -> torch.Tensor:
    """Min-plus APSP (Floyd-Warshall) over the R landmarks."""
    d = torch.clamp(meta_w, max=INF)
    d.fill_diagonal_(0)
    for k in range(meta_w.shape[0]):
        d = torch.minimum(d, d[:, k][:, None] + d[k, :][None, :])
    return torch.clamp(d, max=INF)


def _build_labelling_arrays(engine: FrontierEngine, landmarks: torch.Tensor,
                            is_landmark: torch.Tensor, max_levels: int):
    depth, reach_l = _bfs_rows(engine, landmarks, is_landmark, max_levels)

    # labels only for non-landmarks reached via a landmark-free path
    valid = reach_l & (~is_landmark)[None, :]
    label_dist = torch.where(valid, depth, INF).T.contiguous()   # (V, R)

    # meta edge (r_i, r_j) iff landmark j was reached from root i with the
    # L-bit set; weight = its BFS depth
    lm = landmarks.to(torch.int64)
    meta_w = torch.where(reach_l[:, lm], depth[:, lm], INF)
    meta_w.fill_diagonal_(INF)
    meta_w = torch.minimum(meta_w, meta_w.T)
    return label_dist, meta_w, meta_apsp(meta_w)


def build_labelling(graph: Graph, landmarks, *, max_levels: int = 256,
                    backend: str = "segment",
                    engine: FrontierEngine | None = None, device=None,
                    **engine_kw) -> LabellingScheme:
    """Build the labelling on ``device`` (the CUDA card unless named; the
    graph moves there if it lies elsewhere)."""
    dev = resolve_device(device)
    graph = graph.to(dev)
    landmarks = torch.as_tensor(np.asarray(landmarks, np.int32), device=dev)
    r = int(landmarks.shape[0])
    v = graph.n_vertices
    lm = landmarks.to(torch.int64)
    is_landmark = torch.zeros((v,), dtype=torch.bool, device=dev)
    is_landmark[lm] = True
    lid = torch.full((v,), -1, dtype=torch.int32, device=dev)
    lid[lm] = torch.arange(r, dtype=torch.int32, device=dev)
    if engine is None:
        engine = make_relay(graph, backend=backend, **engine_kw)
    label_dist, meta_w, meta_dist = _build_labelling_arrays(
        engine, landmarks, is_landmark, max_levels)
    return LabellingScheme(landmarks=landmarks, lid=lid,
                           is_landmark=is_landmark, label_dist=label_dist,
                           meta_w=meta_w, meta_dist=meta_dist)


def labelling_size_bytes(scheme: LabellingScheme) -> dict:
    """The paper's size accounting (§6.1): 8 bits per (vertex, landmark)
    for L, plus (pair id, weight) per meta-graph edge.  ``packing.
    packed_size_bytes`` gives the bytes the packed tables occupy."""
    v = int(scheme.label_dist.shape[0])
    r = scheme.n_landmarks
    n_meta = int((scheme.meta_w < INF).sum())
    return {
        "label_bytes": v * r,                # 8 bits per (vertex, landmark)
        "meta_bytes": n_meta * (4 + 1),      # (pair id, weight)
        "n_meta_edges": n_meta,
    }
