"""Query-by-Sketch facade: offline labelling plus planner-routed serving.
Counterpart of ``repro.core.qbs``.

Usage::

    index = QbSIndex.build(graph, n_landmarks=20)     # on the CUDA card
    res = index.query(u, v)                           # one SPG
    res = index.query_batch(us, vs)                   # batched serving

``serving.planner`` classifies a batch into lanes over canonical
deduplicated pairs (trivial, landmark pair, one-sided landmark, general)
and ``serving.service`` runs the lanes in fixed-width chunks.  This module
owns the per-lane device steps:

* ``serve_step`` — the general lane: label gather -> sketch (the fused
  ``sketch_batch`` kernel on the card) -> batched guided search -> edge-mask
  symmetrization through the reverse-edge map.
* ``landmark_pair_step`` / ``landmark_onesided_step`` — the landmark lanes:
  distances from the label rows and the meta-graph APSP, every SPG edge
  certified from two distance fields; the one-sided lane adds one
  distance-bounded full-graph BFS per row (``bfs_depths_batch``).

``backend=`` picks the relay (``segment``, ``csr`` or ``hybrid``); under
``hybrid`` every relay is one call of the fused ``hybrid_relay`` kernel on
the card.  There is no ``use_pallas`` switch: the device decides.

Dynamic graphs (DESIGN.md §13): ``apply_update`` applies one edge
insert/delete batch and returns the index of the next epoch, recomputing
only the affected landmarks' BFS rows; the source index's tensors are
never written, so work still pinned to its epoch keeps its answers.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from .frontier import bfs_depths_batch, make_relay
from .graph import (
    INF,
    Graph,
    apply_edge_updates,
    edge_keys,
    graph_keys,
    in_sorted,
    resolve_device,
    select_landmarks,
)
from .labelling import LabellingScheme, build_labelling, update_labelling
from .packing import pack_labelling, patch_packed, take, widen_dist
from .search import Query, guided_search, make_search_context
from .sketch import compute_sketch_batch


@dataclass(frozen=True)
class SPGResult:
    """One shortest-path-graph answer (host types)."""

    u: int
    v: int
    dist: int                 # INF if disconnected
    edge_ids: np.ndarray      # directed edge-slot ids, symmetrized
    d_top: int

    def edge_pairs(self, graph: Graph) -> set[tuple[int, int]]:
        s = graph.src.cpu().numpy()[self.edge_ids]
        d = graph.dst.cpu().numpy()[self.edge_ids]
        return {(int(min(a, b)), int(max(a, b))) for a, b in zip(s, d)}

    def vertices(self, graph: Graph) -> set[int]:
        s = graph.src.cpu().numpy()[self.edge_ids]
        d = graph.dst.cpu().numpy()[self.edge_ids]
        out = set(map(int, s)) | set(map(int, d))
        if self.dist == 0:
            out |= {self.u}
        return out


def _symmetrize(dist: torch.Tensor, mask: torch.Tensor, rev_edge: torch.Tensor):
    """Edge-mask symmetrization: an edge is on the SPG in both orientations."""
    return dist, mask | mask[:, rev_edge]


def _reverse_edge_map(src: torch.Tensor, dst: torch.Tensor, n: int) -> torch.Tensor:
    """(E,) int64: the slot of each edge's reverse orientation, on the
    edges' device.  A stable sort and a left search, like the reference's
    numpy version, so repeated padding slots map to the same slot."""
    key = src.to(torch.int64) * n + dst.to(torch.int64)
    rkey = dst.to(torch.int64) * n + src.to(torch.int64)
    sorted_key, order = torch.sort(key, stable=True)
    return order[torch.searchsorted(sorted_key, rkey)]


# -- landmark-lane device steps ---------------------------------------------


def _dists_to_landmark_batch(label_dist, meta_dist, lid, is_landmark,
                             r_idx) -> torch.Tensor:
    """(B,) landmark indices -> (B, V) exact d_G(x, landmark) from the label
    rows and the meta APSP (packed or int32 tables)."""
    ld = widen_dist(label_dist)                           # (V, R)
    md = widen_dist(meta_dist)                            # (R, R)
    r_idx = r_idx.to(torch.int64)
    col = md[:, r_idx]                                    # (R, B)
    base = ld[:, 0][None, :] + col[0][:, None]
    for r in range(1, ld.shape[1]):                       # non-landmark rows
        base = torch.minimum(base, ld[:, r][None, :] + col[r][:, None])
    at_lm = md[torch.clamp(lid, min=0).to(torch.int64)][:, r_idx].T   # (B, V)
    out = torch.where(is_landmark[None, :], at_lm, base)
    return torch.clamp(out, max=INF).to(torch.int32)


def _certify_spg_edges_batch(src, dst, rev_edge, du_all, dv_all, d):
    """Edge (x, y) lies on a shortest u-v path iff du(x) + 1 + dv(y) == d;
    symmetrized to both orientations."""
    mask = (du_all[:, src] + 1 + dv_all[:, dst]) == d[:, None]
    return mask | mask[:, rev_edge]


def _landmark_pair_lanes(lm_dist, meta_dist, src, dst, rev_edge, ru, rv):
    """Landmark-landmark lane: (B,) landmark index pairs -> (dist (B,),
    edge_mask (B, E)), label-only."""
    ru = ru.to(torch.int64)
    rv = rv.to(torch.int64)
    d = torch.clamp(widen_dist(take(meta_dist, ru, rv)), max=INF).to(torch.int32)
    mask = _certify_spg_edges_batch(src, dst, rev_edge, widen_dist(take(lm_dist, ru)),
                                    widen_dist(take(lm_dist, rv)), d)
    return d, mask & (d < INF)[:, None]


def _landmark_onesided_lanes(engine, lm_dist, src, dst, rev_edge, roots,
                             r_idx, *, max_levels: int):
    """One-sided landmark lane: one batched full-graph BFS, each row bounded
    at its own d - 1 (``engine`` is the unmasked full-graph relay)."""
    roots = roots.to(torch.int64)
    to_lm = widen_dist(take(lm_dist, r_idx.to(torch.int64)))        # (B, V)
    d = to_lm[torch.arange(roots.shape[0], device=roots.device), roots]
    bounds = torch.where(d < INF, d - 1, 0)   # disconnected rows never expand
    depth = bfs_depths_batch(engine, roots, max_levels, bounds=bounds)
    mask = _certify_spg_edges_batch(src, dst, rev_edge, to_lm, depth, d)
    return d, mask & (d < INF)[:, None]


class QbSIndex:
    """Labelling, packed tables and relay engines of one graph on one device."""

    is_sharded = False   # one device; the vertex-sharded index is not ported

    def __init__(self, graph: Graph, scheme: LabellingScheme, *,
                 max_levels: int = 512, max_chain: int = 512, chunk: int = 32,
                 backend: str = "segment", engine_opts: dict | None = None,
                 epoch: int = 0, lm_dist=None, packed=None):
        self.graph = graph
        self.scheme = scheme
        self.device = graph.device
        self.max_levels = max_levels
        self.max_chain = max_chain
        self.chunk = chunk
        self.backend = backend
        # the epoch of the graph this index answers for; ``apply_update``
        # returns the next epoch's index and records how it resolved the
        # batch (affected set, rebuild) in ``last_update_info``
        self.epoch = epoch
        self.last_update_info: dict = {}
        engine_opts = engine_opts or {}
        self._engine_opts = dict(engine_opts)
        # (R, V) exact vertex-to-landmark distances, built once so the
        # landmark lanes gather rows instead of re-reducing the labels.  The
        # update path keeps the int32 table on the host (``_lm_dist_host``):
        # ``apply_update`` hands the maintained host table in, and an index
        # built from its labels derives it on first use from the packed
        # table (packing is exact).
        if isinstance(lm_dist, np.ndarray):
            self._lm_dist_host = np.asarray(lm_dist, np.int32)
        if packed is None:
            if lm_dist is None:
                lm_dist = _dists_to_landmark_batch(
                    scheme.label_dist, scheme.meta_dist, scheme.lid,
                    scheme.is_landmark,
                    torch.arange(scheme.n_landmarks, device=self.device))
            lm_dist = torch.as_tensor(lm_dist, device=self.device)
            packed = pack_labelling(scheme, lm_dist=lm_dist)
        self.packed = packed
        self._lm_dist = packed.lm_dist
        self.ctx = make_search_context(graph, scheme, backend=backend,
                                       packed=packed, **engine_opts)
        # unmasked full-graph relay for the landmark-endpoint lane (those
        # shortest paths may pass *through* landmarks, so G- is wrong there)
        self._full_engine = make_relay(graph, backend=backend, **engine_opts)
        self._is_landmark_np = scheme.is_landmark.cpu().numpy()
        self._lid_np = scheme.lid.cpu().numpy()
        self._src64 = graph.src.to(torch.int64)
        self._dst64 = graph.dst.to(torch.int64)
        self._service = None

    @cached_property
    def _lm_dist_host(self) -> np.ndarray:
        """(R, V) int32 exact vertex-to-landmark distances on the host, the
        table ``update_labelling`` reads and maintains."""
        return widen_dist(self._lm_dist).cpu().numpy()

    @cached_property
    def _rev_edge_t(self) -> torch.Tensor:
        """Built at first query, like the reference's lazy map."""
        return _reverse_edge_map(self.graph.src, self.graph.dst,
                                 self.graph.n_vertices)

    # -- per-lane device steps ----------------------------------------------

    def serve_step(self, us: torch.Tensor, vs: torch.Tensor):
        """The general lane: one chunk ``(B,)`` int32 through sketch + guided
        search + symmetrization -> device ``(dist (B,), edge_mask (B, E))``.
        Landmark-endpoint rows are garbage here; the planner routes them to
        the landmark lane steps."""
        label_dist = self.packed.label_dist
        lu = take(label_dist, us.to(torch.int64))
        lv = take(label_dist, vs.to(torch.int64))
        sk = compute_sketch_batch(lu, lv, self.packed.meta_w,
                                  self.packed.meta_dist)
        q = Query(u=us, v=vs, d_top=sk.d_top, du_land=sk.du_land,
                  dv_land=sk.dv_land, meta_edge=sk.meta_edge,
                  d_star_u=sk.d_star_u, d_star_v=sk.d_star_v)
        res = guided_search(self.ctx, q, self.graph.n_vertices,
                            max_levels=self.max_levels,
                            max_chain=self.max_chain)
        return _symmetrize(res.dist, res.edge_mask, self._rev_edge_t)

    def landmark_pair_step(self, ru: torch.Tensor, rv: torch.Tensor):
        """Landmark-landmark lane: (B,) landmark-index pairs -> device
        ``(dist (B,), edge_mask (B, E))``, label-only."""
        return _landmark_pair_lanes(self._lm_dist, self.packed.meta_dist,
                                    self._src64, self._dst64, self._rev_edge_t,
                                    ru, rv)

    def landmark_onesided_step(self, roots: torch.Tensor, r_idx: torch.Tensor):
        """One-sided landmark lane: (B,) non-landmark roots + (B,) landmark
        indices -> device ``(dist (B,), edge_mask (B, E))``."""
        return _landmark_onesided_lanes(
            self._full_engine, self._lm_dist, self._src64, self._dst64,
            self._rev_edge_t, roots, r_idx, max_levels=self.max_levels)

    # -- dynamic updates (DESIGN.md §13) -------------------------------------

    def apply_update(self, inserts=None, deletes=None, *,
                     churn_threshold: float = 0.5) -> "QbSIndex":
        """Apply one edge-update batch and return the index of the next
        epoch.  ``self`` is untouched: ``update_labelling`` and
        ``patch_packed`` write into copies, so chunks pinned to this epoch
        keep its answers.

        The landmark set stays pinned; only the affected landmarks' BFS rows
        are recomputed on the new graph, and past ``churn_threshold``
        (affected fraction of R) the labelling is rebuilt outright.  Either
        way the new tables equal a fresh build on the new graph with the
        same landmarks.
        """
        # the effective delta: insert-of-present and delete-of-absent edges
        # are no-ops and must never flag a landmark
        n_v = self.graph.n_vertices
        present = graph_keys(self.graph)              # sorted, unique
        ins0 = edge_keys(inserts, n_v) if inserts is not None else \
            np.zeros((0,), np.int64)
        del0 = edge_keys(deletes, n_v) if deletes is not None else \
            np.zeros((0,), np.int64)
        ins = ins0[~in_sorted(ins0, present)]         # insert-of-absent only
        dels = del0[in_sorted(del0, present)]         # delete-of-present only
        dels = dels[~in_sorted(dels, ins0)]           # inserts win a tie
        ins_arr = np.stack([ins // n_v, ins % n_v], axis=1)
        del_arr = np.stack([dels // n_v, dels % n_v], axis=1)

        graph_new = apply_edge_updates(self.graph, ins_arr, del_arr)
        scheme_new, lm_new, info = update_labelling(
            graph_new, self.scheme, self._lm_dist_host, ins_arr, del_arr,
            backend=self.backend, churn_threshold=churn_threshold,
            **self._engine_opts)
        kw = dict(max_levels=self.max_levels, max_chain=self.max_chain,
                  chunk=self.chunk, backend=self.backend,
                  engine_opts=self._engine_opts, epoch=self.epoch + 1)
        if scheme_new is None:  # churn above threshold: full rebuild
            scheme_new = build_labelling(
                graph_new, self.scheme.landmarks.cpu().numpy(),
                backend=self.backend, device=self.device, **self._engine_opts)
            new = QbSIndex(graph_new, scheme_new, **kw)
        else:
            if info["n_affected"]:
                packed_new = patch_packed(
                    self.packed, scheme_new, lm_new, info["affected"])
            else:
                packed_new = self.packed  # labels untouched; only CSR moved
            new = QbSIndex(graph_new, scheme_new, lm_dist=lm_new,
                           packed=packed_new, **kw)
        new.last_update_info = info
        return new

    # -- construction -------------------------------------------------------

    @classmethod
    def build(cls, graph: Graph, n_landmarks: int = 20,
              landmarks: np.ndarray | None = None, *, device=None, **kw):
        """Build an index on ``device`` (the CUDA card unless named; raises
        without one).  ``kw`` goes to ``QbSIndex``: ``backend``,
        ``engine_opts`` (``n_hubs``), ``chunk``, ``max_levels``,
        ``max_chain``."""
        dev = resolve_device(device)
        graph = graph.to(dev)
        if landmarks is None:
            landmarks = select_landmarks(graph, n_landmarks)
        scheme = build_labelling(graph, landmarks,
                                 backend=kw.get("backend", "segment"),
                                 device=dev, **(kw.get("engine_opts") or {}))
        return cls(graph, scheme, **kw)

    # -- queries (thin delegates over the planner/service) -------------------

    def make_service(self, **kw):
        """A ``serving.ServingService`` over this index (``async_depth``,
        ``chunk``, the result cache and its policies)."""
        from ..serving.service import ServingService
        return ServingService(self, **kw)

    def make_stream(self, *, policy=None, **kw):
        """A ``serving.StreamingService``: queries arrive over time
        (``submit``/``drain``, per-query futures) and are coalesced into
        planner batches under the deadline/QoS scheduler; ``kw`` passes
        through (``qos=``, ``clock=``, and the inner ``ServingService``'s
        arguments)."""
        from ..serving.stream import StreamingService
        return StreamingService(self, policy=policy, **kw)

    def _default_service(self):
        if self._service is None:
            self._service = self.make_service()
        return self._service

    def query_batch(self, us, vs) -> list[SPGResult]:
        return self._default_service().query_batch(us, vs)

    def query_batch_arrays(self, us, vs) -> tuple[np.ndarray, np.ndarray]:
        """Answer a batch as raw host arrays (dist (N,) int32, edge_mask
        (N, E) bool, symmetrized)."""
        return self._default_service().query_arrays(us, vs)

    def query(self, u: int, v: int) -> SPGResult:
        return self.query_batch([u], [v])[0]
