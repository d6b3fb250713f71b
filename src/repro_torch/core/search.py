"""Algorithm 4 (guided searching), batched over a chunk of queries.
Counterpart of ``repro.core.search``.

Sketch-bounded bidirectional BFS on the sparsified graph G- = G[V \\ R],
then a reverse search (the SPG edges avoiding landmarks) and a recover
search (shortest paths through landmarks, re-attached from the labels).

The reference writes each stage for one query and ``vmap``s it; a batched
``while_loop`` iterates while *any* row's condition holds and freezes the
rows whose condition is false.  The port writes the ``(B, ...)`` loops out:
each level computes the per-row ``active`` mask, updates only active rows,
and the loop runs while ``active.any()`` (one host sync per level).

Full-width memory: the reference's ``(E, R)`` per-query temporaries become
``(B, E, R)`` when batched (17 GB in int32 on a 6.6 M-slot graph at
B = 32, R = 20).  The port reduces over landmarks in a loop and keeps
only ``(B, E)`` or ``(B, V)`` temporaries; min and OR are order-free, so
the results are bit-identical.  The landmark-incident edge sets are static
per index and are compacted once, in ``make_search_context``.  The recover
search's side attach goes through the kernel seam (``ops.side_attach``):
on the card a hand-written kernel that tests the label decrement from the
label rows, on the CPU the plain loop over per-landmark edge lists that it
builds at its first call.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import trace
from ..kernels import ops
from .frontier import FrontierEngine, make_relay
from .graph import INF, Graph
from .packing import PackedLabels, pack_dist, pack_labelling, widen_dist


class LandmarkEdges(NamedTuple):
    """Static edge subsets the Delta stage reads (all int64 index lists).

    ``at_src``/``at_dst`` = ``(eid, r, other, other_is_lm)`` of the edges
    whose src (resp. dst) is landmark r.  ``ll`` = ``(eid, i, j)`` of the
    edges between landmarks i (src) and j (dst)."""

    at_src: tuple
    at_dst: tuple
    ll: tuple


class SearchContext(NamedTuple):
    """Per-graph constants shared by every query."""

    src: torch.Tensor           # (E,) int32
    dst: torch.Tensor           # (E,) int32, src-sorted: the CSR columns
    indptr: torch.Tensor        # (V+1,) int32 CSR row offsets into dst
    gminus_e: torch.Tensor      # (E,) bool: both endpoints are non-landmarks
    is_landmark: torch.Tensor   # (V,) bool
    lid: torch.Tensor           # (V,) int32: vertex -> landmark index, -1 otherwise
    label_dist: torch.Tensor    # (V, R) packed uint8/uint16 (sentinel = INF)
    meta_w: torch.Tensor        # (R, R) packed direct meta edge weights
    engine: FrontierEngine      # G- relay (gminus_e baked in as the edge mask)
    edges: LandmarkEdges        # static edge subsets (see LandmarkEdges)


def _landmark_edges(src, dst, is_landmark, lid) -> LandmarkEdges:
    src64 = src.to(torch.int64)
    dst64 = dst.to(torch.int64)

    def at(end, other):
        eid = torch.nonzero(is_landmark[end])[:, 0]
        o = other[eid]
        return eid, lid[end[eid]].to(torch.int64), o, is_landmark[o]

    ll = torch.nonzero(is_landmark[src64] & is_landmark[dst64])[:, 0]
    return LandmarkEdges(
        at_src=at(src64, dst64), at_dst=at(dst64, src64),
        ll=(ll, lid[src64[ll]].to(torch.int64), lid[dst64[ll]].to(torch.int64)))


def make_search_context(graph: Graph, scheme=None, *, backend: str = "segment",
                        engine: FrontierEngine | None = None,
                        packed: PackedLabels | None = None,
                        **engine_kw) -> SearchContext:
    """Build the per-graph search context on the graph's device.
    ``scheme=None`` means an empty landmark set (the Bi-BFS degeneration).
    The label tables enter packed: pass ``packed=`` to share the caller's
    ``PackedLabels``, otherwise the scheme is packed here."""
    v, e = graph.n_vertices, graph.n_edges
    dev = graph.device
    src, dst = graph.src, graph.dst
    if scheme is None:
        gminus_e = torch.ones((e,), dtype=torch.bool, device=dev)
        is_landmark = torch.zeros((v,), dtype=torch.bool, device=dev)
        lid = torch.full((v,), -1, dtype=torch.int32, device=dev)
        label_dist = pack_dist(np.full((v, 1), INF, np.int32), np.uint8, device=dev)
        meta_w = pack_dist(np.full((1, 1), INF, np.int32), np.uint8, device=dev)
    else:
        is_landmark = scheme.is_landmark
        gminus_e = (~is_landmark[src]) & (~is_landmark[dst])
        lid = scheme.lid
        if packed is None:
            packed = pack_labelling(scheme)
        label_dist = packed.label_dist
        meta_w = packed.meta_w
    if engine is None:
        engine = make_relay(graph, backend=backend, edge_mask=gminus_e,
                            **engine_kw)
    edges = _landmark_edges(src, dst, is_landmark, lid)
    return SearchContext(src=src, dst=dst, indptr=graph.indptr,
                         gminus_e=gminus_e,
                         is_landmark=is_landmark, lid=lid,
                         label_dist=label_dist, meta_w=meta_w, engine=engine,
                         edges=edges)


class Query(NamedTuple):
    """A batch of queries with their sketches (leading axis = batch)."""

    u: torch.Tensor          # (B,) int32
    v: torch.Tensor          # (B,) int32
    d_top: torch.Tensor      # (B,) int32
    du_land: torch.Tensor    # (B, R) int32 sigma_S(u, r)
    dv_land: torch.Tensor    # (B, R) int32 sigma_S(v, r')
    meta_edge: torch.Tensor  # (B, R, R) bool
    d_star_u: torch.Tensor   # (B,) int32
    d_star_v: torch.Tensor   # (B,) int32


class SearchResult(NamedTuple):
    edge_mask: torch.Tensor  # (B, E) bool, path-direction orientation marks
    dist: torch.Tensor       # (B,) int32, INF if disconnected
    d_minus: torch.Tensor    # (B,) int32 d_{G-}(u, v), INF if balls never met
    d_u: torch.Tensor        # (B,) int32 explored radius, u side
    d_v: torch.Tensor        # (B,) int32 explored radius, v side


# ---------------------------------------------------------------------------
# Stage 1: sketch-bounded bidirectional BFS on G-  (Alg. 4 lines 1-15)
# ---------------------------------------------------------------------------

def bidirectional_bfs(ctx: SearchContext, q: Query, n_vertices: int,
                      max_levels: int):
    """Per row: expand one side per level until the balls meet, the budget
    d_u + d_v reaches d_top (or ``max_levels``), or both sides die out.
    Only the picked side of each row is relayed (B rows per level); the
    reference expands both and keeps one, which gives the same state."""
    b = q.u.shape[0]
    dev = q.u.device
    rows = torch.arange(b, device=dev)
    depth_u = torch.full((b, n_vertices), INF, dtype=torch.int32, device=dev)
    depth_v = depth_u.clone()
    depth_u[rows, q.u.to(torch.int64)] = 0
    depth_v[rows, q.v.to(torch.int64)] = 0
    d_u = torch.zeros((b,), dtype=torch.int32, device=dev)
    d_v = torch.zeros_like(d_u)
    alive_u = torch.ones((b,), dtype=torch.bool, device=dev)
    alive_v = alive_u.clone()
    met = torch.zeros_like(alive_u)

    while True:
        s = d_u + d_v
        active = (s < q.d_top) & (s < max_levels) & ~met & (alive_u | alive_v)
        trace.count("search.host_syncs")
        if not bool(active.any()):
            break
        trace.count("search.bfs_levels")
        # pick_search: prefer the side whose sketch budget d* is unmet; on a
        # tie use the smaller explored ball (paper's |P_u| vs |P_v| rule)
        want_u = q.d_star_u > d_u
        want_v = q.d_star_v > d_v
        size_u = (depth_u < INF).sum(dim=1)
        size_v = (depth_v < INF).sum(dim=1)
        pick_u = torch.where(want_u != want_v, want_u, size_u <= size_v)
        pick_u = torch.where(alive_u & alive_v, pick_u, alive_u)

        depth = torch.where(pick_u[:, None], depth_u, depth_v)
        d = torch.where(pick_u, d_u, d_v)
        msg = ctx.engine.relay((depth == d[:, None]) & active[:, None])
        new = msg & (depth == INF)
        grown = torch.where(new, (d + 1)[:, None], depth)
        upd_u = active & pick_u
        upd_v = active & ~pick_u
        depth_u = torch.where(upd_u[:, None], grown, depth_u)
        depth_v = torch.where(upd_v[:, None], grown, depth_v)
        d_u = torch.where(upd_u, d_u + 1, d_u)
        d_v = torch.where(upd_v, d_v + 1, d_v)
        any_new = new.any(dim=1)
        alive_u = torch.where(upd_u, any_new, alive_u)
        alive_v = torch.where(upd_v, any_new, alive_v)
        met = torch.where(active, ((depth_u < INF) & (depth_v < INF)).any(dim=1),
                          met)
    return depth_u, depth_v, d_u, d_v, alive_u, alive_v, met


# ---------------------------------------------------------------------------
# Stage 2: reverse search  (Alg. 4 lines 16-17)
# ---------------------------------------------------------------------------

def reverse_search(ctx: SearchContext, depth_u: torch.Tensor,
                   depth_v: torch.Tensor, d_minus: torch.Tensor) -> torch.Tensor:
    """The SPG edges of shortest u-v paths inside G-, chained backward from
    the meeting set W = {x : depth_u[x] + depth_v[x] == d_minus} on each
    side, one relay per level; each row walks from its own start level.
    Certified edges are oriented along the u->v path direction."""
    common = (depth_u < INF) & (depth_v < INF)
    w_set = common & (depth_u + depth_v == d_minus[:, None])
    src = ctx.src.to(torch.int64)
    dst = ctx.dst.to(torch.int64)

    def sweep(depth, toward_u: bool):
        level = torch.where(w_set, depth, 0).amax(dim=1)      # (B,)
        d_src = depth[:, src]
        d_dst = depth[:, dst]
        on = w_set
        emask = torch.zeros((depth.shape[0], src.shape[0]), dtype=torch.bool,
                            device=depth.device)
        while True:
            act = level >= 1
            trace.count("search.host_syncs")
            if not bool(act.any()):
                break
            lc = level[:, None]
            if toward_u:
                # (x -> y) with depth[x] == l-1, depth[y] == l, y on-path
                cert = on[:, dst] & (d_dst == lc) & (d_src == lc - 1)
            else:
                # (x -> y) with depth_v[x] == l, depth_v[y] == l-1
                cert = on[:, src] & (d_src == lc) & (d_dst == lc - 1)
            emask |= cert & ctx.gminus_e & act[:, None]
            relayed = ctx.engine.relay(on & (depth == lc) & act[:, None])
            on = on | ((depth == lc - 1) & relayed)
            level = torch.where(act, level - 1, level)
        return emask

    return sweep(depth_u, True) | sweep(depth_v, False)


# ---------------------------------------------------------------------------
# Stage 3: recover search  (Alg. 4 lines 18-24)
# ---------------------------------------------------------------------------

def _side_attach(ctx: SearchContext, depth: torch.Tensor,
                 side_land: torch.Tensor, n_vertices: int, max_chain: int,
                 out: torch.Tensor | None = None):
    """Component (i)/(ii): edges of landmark-free shortest t->r paths for
    every sketch edge (r, t): the pointwise certificate (G- BFS prefix +
    label suffix == sigma), the anchor-chain closure beyond the explored
    ball along label-decrement edges of G- (at most ``max_chain`` steps,
    one host sync each), then the interior edges and the final hops into
    the landmark.

    Returns ``(edge_mask (B, E), on)``, ``on`` as ``(V, ceil(B / 32), R)``
    int32 words (``kernels.ref.unpack_on`` gives the ``(R, B, V)`` bools:
    ``on[r, b, x]`` certifies x on such a path for query b); with ``out``
    the edges are ORed into it.  ``ops.side_attach`` runs the kernel on the
    card and the plain loop on the CPU."""
    return ops.side_attach(depth, side_land, ctx.label_dist, ctx.indptr,
                           ctx.src, ctx.dst, ctx.lid, max_chain, out)


def _delta_edges(ctx: SearchContext, meta_edge: torch.Tensor) -> torch.Tensor:
    """Component (iii): edges on landmark-free shortest r_i - r_j paths for
    every meta edge in the sketch, from the labels alone.  A G- edge (x, y)
    is on such a path iff min_{i,j} masked(ld[x,i] + ld[y,j] - w[i,j]) == -1
    (the triangle inequality makes -1 the least value).

    A pair (i, j) outside the query's sketch enters the reference's min as
    ``+INF`` and its term is at least INF, so it can neither be -1 nor hide
    one: the min runs over the sketch's own (query, i, j) triples only, a
    handful per query, one ``(E,)`` row update each."""
    ld = widen_dist(ctx.label_dist)                  # (V, R)
    w = widen_dist(ctx.meta_w)
    n_r = ld.shape[1]
    b = meta_edge.shape[0]
    e = ctx.src.shape[0]
    dev = ld.device
    fin = (w < INF)[None] & meta_edge                # (B, i, j)

    src = ctx.src.to(torch.int64)
    dst = ctx.dst.to(torch.int64)
    ld_t = ld.T.contiguous()                         # (R, V)
    w_host = w.tolist()
    trace.count("search.host_syncs")
    at_src: dict[int, torch.Tensor] = {}
    at_dst: dict[int, torch.Tensor] = {}
    minval = torch.full((b, e), 3 * INF, dtype=torch.int32, device=dev)
    triples = torch.nonzero(fin).tolist()
    trace.count("search.host_syncs", 2)   # the nonzero, then the copy
    for row, i, j in triples:
        if i not in at_src:
            at_src[i] = ld_t[i][src]
        if j not in at_dst:
            at_dst[j] = ld_t[j][dst]
        minval[row] = torch.minimum(minval[row],
                                    at_src[i] + (at_dst[j] - w_host[i][j]))
    out = ctx.gminus_e & (minval == -1)

    # boundary hops r_i -> y (y has ld[y, j] == w[i, j] - 1) and x -> r_j
    g1 = torch.where(fin, w[None] - 1, -1)          # (B, i, j) rows: src landmark
    h1 = g1.transpose(1, 2)                         # (B, j, i) rows: dst landmark

    def hop(at, table):
        eid, r_idx, other, other_lm = at
        keep = ~other_lm
        eid, r_idx, other = eid[keep], r_idx[keep], other[keep]
        trace.count("search.host_syncs", 3)   # a boolean index is a nonzero
        match = torch.zeros((b, eid.shape[0]), dtype=torch.bool, device=dev)
        for j in range(n_r):
            match |= ld[other, j][None, :] == table[:, r_idx, j]
        hops = torch.zeros((b, e), dtype=torch.bool, device=dev)
        hops[:, eid] = match
        return hops

    out |= hop(ctx.edges.at_src, g1) | hop(ctx.edges.at_dst, h1)

    # direct landmark-landmark sketch edges of weight 1
    eid, i_idx, j_idx = ctx.edges.ll
    direct = meta_edge[:, i_idx, j_idx] & (w[i_idx, j_idx] == 1)[None, :]
    out[:, eid] |= direct
    return out


def recover_search(ctx: SearchContext, q: Query, depth_u: torch.Tensor,
                   depth_v: torch.Tensor, n_vertices: int,
                   max_chain: int) -> torch.Tensor:
    with trace.span("search.attach", depth_u):
        edges, _ = _side_attach(ctx, depth_u, q.du_land, n_vertices, max_chain)
    with trace.span("search.attach", depth_v):
        _side_attach(ctx, depth_v, q.dv_land, n_vertices, max_chain, out=edges)
    with trace.span("search.delta", depth_u):
        edges |= _delta_edges(ctx, q.meta_edge)
    return edges


# ---------------------------------------------------------------------------
# Full guided search for a batch of queries
# ---------------------------------------------------------------------------

def guided_search(ctx: SearchContext, q: Query, n_vertices: int,
                  max_levels: int = 64, max_chain: int = 64) -> SearchResult:
    """The reverse and recover stages run only on the rows whose answer
    reads them (rows are independent, so the subset gives the same bits
    the masked full batch would)."""
    b = q.u.shape[0]
    trace.count("search.rows", b)
    with trace.span("search.bfs", q.u):
        depth_u, depth_v, d_u, d_v, _, _, met = bidirectional_bfs(
            ctx, q, n_vertices, max_levels)

    common = (depth_u < INF) & (depth_v < INF)
    d_minus = torch.where(common, depth_u + depth_v, INF).amin(dim=1)
    dist = torch.minimum(d_minus, q.d_top)
    reverse_on = met & (d_minus <= q.d_top)
    recover_on = (q.d_top < INF) & (q.d_top <= d_minus)
    trivial = q.u == q.v

    edge_mask = torch.zeros((b, ctx.src.shape[0]), dtype=torch.bool,
                            device=depth_u.device)
    with trace.span("search.reverse", q.u):
        rows = torch.nonzero(reverse_on & ~trivial)[:, 0]
        trace.count("search.host_syncs")
        if rows.numel():
            edge_mask[rows] |= reverse_search(ctx, depth_u[rows], depth_v[rows],
                                              d_minus[rows])
    rows = torch.nonzero(recover_on & ~trivial)[:, 0]
    trace.count("search.host_syncs")
    trace.count("search.recover_rows", rows.numel())
    if rows.numel():
        sub = Query(*(t[rows] for t in q))
        edge_mask[rows] |= recover_search(ctx, sub, depth_u[rows],
                                          depth_v[rows], n_vertices, max_chain)
    dist = torch.where(trivial, 0, dist)
    return SearchResult(edge_mask=edge_mask, dist=dist.to(torch.int32),
                        d_minus=d_minus.to(torch.int32), d_u=d_u, d_v=d_v)
