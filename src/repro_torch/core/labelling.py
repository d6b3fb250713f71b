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


def _build_labelling_rows(engine: FrontierEngine, roots: torch.Tensor,
                          landmarks: torch.Tensor, is_landmark: torch.Tensor,
                          max_levels: int):
    """The incremental-update slice of the build: BFS rows for a subset of
    landmark roots on the post-update graph, returning the pieces
    ``update_labelling`` writes back into the old scheme: depth rows
    ``(K, V)`` (the new lm_dist rows), label columns ``(V, K)`` and raw
    (pre-symmetrization) meta rows ``(K, R)``."""
    depth, reach_l = _bfs_rows(engine, roots, is_landmark, max_levels)
    valid = reach_l & (~is_landmark)[None, :]
    label_cols = torch.where(valid, depth, INF).T.contiguous()      # (V, K)
    lm = landmarks.to(torch.int64)
    meta_rows = torch.where(reach_l[:, lm], depth[:, lm], INF)      # (K, R)
    return depth, label_cols, meta_rows


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


# ---------------------------------------------------------------------------
# Incremental maintenance (DESIGN.md §13): affected-landmark recompute.
# ---------------------------------------------------------------------------


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def affected_landmarks(
    scheme: LabellingScheme,
    lm_dist: np.ndarray,
    graph_new: Graph,
    inserts: np.ndarray | None = None,
    deletes: np.ndarray | None = None,
) -> np.ndarray:
    """``(R,)`` bool mask of landmarks whose BFS row an update batch touches.
    Host numpy, copied from the reference (the scheme's and the graph's
    tensors are read on the host).

    ``lm_dist`` is the exact pre-update ``(R, V)`` distance table,
    ``graph_new`` the post-batch graph, and ``inserts``/``deletes`` the
    *effective* delta (insert-of-absent / delete-of-present edges only).
    Per landmark r and edge (a, b) with a the endpoint nearer r:

    * ``|d(r,a) - d(r,b)| >= 2`` insert: distances shorten — affected.
    * equal depths (or both INF): unchanged.
    * ``diff == 1`` insert: the row changes only if a's live
      L-contribution reaches a b that lacked the L-bit:
      ``reach_L(a) & ok(a) & ~reach_L(b)``.
    * ``diff == 1`` delete: affected if b loses its last surviving shortest
      predecessor (checked against ``graph_new``'s CSR), or if the removed
      edge carried a live L-contribution into a reached b and no surviving
      predecessor still contributes one.

    reach_L is read off the existing tables: ``label_dist[x, r] < INF`` for
    non-landmark x, ``meta_w[r, lid[x]] < INF`` for landmark x (row r's own
    root is True); ``propagate_ok`` is false exactly for non-root landmarks.
    """
    lm = np.asarray(lm_dist)
    R = lm.shape[0]
    aff = np.zeros((R,), bool)
    label = _host(scheme.label_dist)         # (V, R)
    meta_w = _host(scheme.meta_w)            # (R, R)
    lid = _host(scheme.lid)
    is_lm = _host(scheme.is_landmark)
    indptr = _host(graph_new.indptr)
    dst = _host(graph_new.dst)

    def reach(x: int) -> np.ndarray:
        """(R,) reach_L[r, x]: a landmark-interior-free shortest r-x path."""
        if is_lm[x]:
            out = meta_w[:, lid[x]] < INF
            out[lid[x]] = True                   # own root
            return out
        return label[x, :] < INF

    def contrib(x: int) -> np.ndarray:
        """(R,) live L-contribution of x: reach_L & propagate_ok."""
        if is_lm[x]:
            out = np.zeros((R,), bool)
            out[lid[x]] = True                   # roots relay their own bit
            return out
        return label[x, :] < INF

    def _pairs(arr):
        if arr is None:
            return ()
        arr = np.asarray(arr, np.int64).reshape(-1, 2)
        return [(int(a), int(b)) for a, b in arr]

    for u, v in _pairs(inserts):
        du, dv = lm[:, u], lm[:, v]
        gap = np.abs(du - dv)
        rows = gap >= 2
        one = gap == 1
        if one.any():
            cu, cv, ru, rv = contrib(u), contrib(v), reach(u), reach(v)
            a_is_u = du < dv                     # a = nearer endpoint
            rows = rows | (one & np.where(a_is_u, cu & ~rv, cv & ~ru))
        aff |= rows

    def _pred_keep(x: int, dx: np.ndarray):
        """For farther endpoint x: (R,) has-surviving-shortest-predecessor
        and (R,) some survivor still carries a live L-contribution."""
        nb = dst[indptr[x]:indptr[x + 1]]
        nb = nb[nb != x]                         # drop self-loop padding
        if not nb.size:
            z = np.zeros((R,), bool)
            return z, z
        at_depth = lm[:, nb] == (dx - 1)[:, None]        # (R, deg)
        contrib_nb = (label[nb, :] < INF).T              # (R, deg)
        lm_nb = np.nonzero(is_lm[nb])[0]
        for j in lm_nb:                                  # landmark neighbors:
            contrib_nb[lid[nb[j]], j] = True             # roots relay own bit
        return at_depth.any(axis=1), (at_depth & contrib_nb).any(axis=1)

    for u, v in _pairs(deletes):
        du, dv = lm[:, u], lm[:, v]
        one = np.abs(du - dv) == 1               # real edges: gap <= 1
        if not one.any():
            continue
        cu, cv, ru, rv = contrib(u), contrib(v), reach(u), reach(v)
        a_is_u = du < dv
        pred_u, keep_u = _pred_keep(u, du)
        pred_v, keep_v = _pred_keep(v, dv)
        orphaned = np.where(a_is_u, ~pred_v, ~pred_u)
        l_loss = np.where(a_is_u, cu & rv & ~keep_v, cv & ru & ~keep_u)
        aff |= one & (orphaned | l_loss)
    return aff


def update_labelling(
    graph_new: Graph,
    scheme: LabellingScheme,
    lm_dist: np.ndarray,
    inserts: np.ndarray | None = None,
    deletes: np.ndarray | None = None,
    *,
    max_levels: int = 256,
    backend: str = "segment",
    engine: FrontierEngine | None = None,
    churn_threshold: float = 0.5,
    **engine_kw,
) -> tuple[LabellingScheme | None, np.ndarray | None, dict]:
    """Incrementally maintain a labelling across one edge-update batch.

    Returns ``(scheme_new, lm_dist_new, info)``, both tables equal to a
    fresh ``build_labelling`` on ``graph_new`` (``lm_dist`` and
    ``lm_dist_new`` are host ``(R, V)`` int32 arrays).  Past
    ``churn_threshold`` (affected fraction of R) it returns ``(None, None,
    info)`` with ``info["full_rebuild"]`` set and the caller rebuilds.

    The affected roots' BFS rows run on the scheme's device, all in one
    batch (under ``backend="hybrid"`` every level is one ``hybrid_relay``
    call).  The reference pads the root subset to its compile-cache width
    ladder with duplicate roots; nothing here compiles per shape, so the
    port runs exactly the affected roots.  The scheme's tables are never
    written: the label table is cloned before the affected columns are
    written into it, so an index still serving the old epoch keeps its
    tables.
    """
    lm = np.asarray(lm_dist, np.int32)
    R = scheme.n_landmarks
    aff = affected_landmarks(scheme, lm, graph_new, inserts, deletes)
    idx = np.nonzero(aff)[0].astype(np.int32)
    info = {"affected": idx, "full_rebuild": False, "n_affected": int(idx.size)}
    if idx.size == 0:
        return scheme, lm, info
    if idx.size > churn_threshold * R:
        info["full_rebuild"] = True
        return None, None, info

    if engine is None:
        engine = make_relay(graph_new, backend=backend, **engine_kw)
    dev = scheme.label_dist.device
    idx_t = torch.as_tensor(idx, device=dev).to(torch.int64)
    depth, label_cols, meta_rows = _build_labelling_rows(
        engine, scheme.landmarks[idx_t], scheme.landmarks,
        scheme.is_landmark, max_levels)
    label_dist = scheme.label_dist.clone()
    label_dist[:, idx_t] = label_cols
    depth = depth.cpu().numpy()                # (K, V): new lm_dist rows
    meta_rows = meta_rows.cpu().numpy()        # (K, R) raw, diag carries 0
    # Raw meta values are symmetric, and an entry (i, j) only changes when
    # d(r_i, r_j) or its L-bit moves, which flags both rows: write the rows
    # into both the rows and the columns of the affected set, reset the
    # affected diagonal to INF and re-harmonize with the transpose.
    meta_w = scheme.meta_w.cpu().numpy().copy()
    meta_w[idx, :] = meta_rows
    meta_w[:, idx] = meta_rows.T
    meta_w[idx, idx] = INF
    meta_w = torch.as_tensor(np.minimum(meta_w, meta_w.T), device=dev)

    lm_new = lm.copy()
    lm_new[idx] = depth
    scheme_new = LabellingScheme(
        landmarks=scheme.landmarks, lid=scheme.lid,
        is_landmark=scheme.is_landmark, label_dist=label_dist,
        meta_w=meta_w, meta_dist=meta_apsp(meta_w))
    return scheme_new, lm_new, info
