"""Baselines from the paper (§3, §6.1) plus the exact oracle.
Counterpart of ``repro.core.baselines``.

* ``bfs_spg``      — textbook oracle: two full BFSs; an edge (x, y) lies on a
                     shortest u-v path iff d_u(x) + 1 + d_v(y) == d(u, v).
* ``bibfs_spg``    — the paper's search baseline (Bi-BFS): a degenerate
                     guided search with an empty landmark set
                     (``make_search_context(graph, None)``), which is what
                     QbS reduces to without a sketch.
* ``PPLIndex``     — pruned path labelling (Algorithm 1): PLL with the
                     equal-distance pruning removed so 2-hop *path* cover
                     holds; recursive query answering.  ``store_parents``
                     gives ParentPPL: per-label parent sets that accelerate
                     edge emission while the recursion keeps it exact.

The BFS baselines run on the relay engine, on ``device`` (the CUDA card
unless named).  PPL is host numpy with a dense ``(V, V)`` label table, as
in the reference: its role in the paper is to show that this family does
not scale (Tables 2-3), so it runs at small sizes only.  Results carry
int64 ``edge_ids`` (``flatnonzero`` order), as the reference's do.
"""
from __future__ import annotations

import numpy as np
import torch

from .frontier import bfs_depths, make_relay
from .graph import INF, Graph, resolve_device
from .qbs import SPGResult, _reverse_edge_map
from .search import Query, guided_search, make_search_context


def _edge_ids(mask: torch.Tensor) -> np.ndarray:
    return torch.nonzero(mask)[:, 0].cpu().numpy().astype(np.int64)


# ---------------------------------------------------------------------------
# Oracle
# ---------------------------------------------------------------------------


def bfs_distances(graph: Graph, root: int, max_levels: int = 256,
                  backend: str = "segment", device=None) -> np.ndarray:
    graph = graph.to(resolve_device(device))
    return bfs_depths(make_relay(graph, backend=backend), root,
                      max_levels).cpu().numpy()


def bfs_spg(graph: Graph, u: int, v: int, max_levels: int = 256,
            backend: str = "segment", device=None) -> SPGResult:
    """Exact oracle via two full BFSs (O(E) each, no pruning)."""
    graph = graph.to(resolve_device(device))
    engine = make_relay(graph, backend=backend)
    du = bfs_depths(engine, u, max_levels)
    dv = bfs_depths(engine, v, max_levels)
    d = int(du[v])
    if u == v:
        return SPGResult(u=u, v=v, dist=0, edge_ids=np.zeros((0,), np.int64),
                         d_top=INF)
    src = graph.src.to(torch.int64)
    dst = graph.dst.to(torch.int64)
    mask = (du[src] + 1 + dv[dst]) == d
    mask = mask | mask[_reverse_edge_map(graph.src, graph.dst, graph.n_vertices)]
    return SPGResult(u=u, v=v, dist=d, edge_ids=_edge_ids(mask), d_top=INF)


# ---------------------------------------------------------------------------
# Bi-BFS baseline = guided search with an empty landmark set
# ---------------------------------------------------------------------------


def bibfs_spg_batch(graph: Graph, us, vs, max_levels: int = 512,
                    backend: str = "segment", device=None) -> list[SPGResult]:
    dev = resolve_device(device)
    graph = graph.to(dev)
    us = np.asarray(us, np.int32).reshape(-1)
    vs = np.asarray(vs, np.int32).reshape(-1)
    # empty landmark set -> G- == G, the Bi-BFS degeneration
    ctx = make_search_context(graph, None, backend=backend)
    b = us.shape[0]

    def full(shape, value, dtype=torch.int32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    queries = Query(
        u=torch.from_numpy(us).to(dev), v=torch.from_numpy(vs).to(dev),
        d_top=full((b,), INF),
        du_land=full((b, 1), INF), dv_land=full((b, 1), INF),
        meta_edge=full((b, 1, 1), False, torch.bool),
        d_star_u=full((b,), 0), d_star_v=full((b,), 0),
    )
    res = guided_search(ctx, queries, graph.n_vertices, max_levels=max_levels,
                        max_chain=1)
    rev = _reverse_edge_map(graph.src, graph.dst, graph.n_vertices)
    mask = res.edge_mask | res.edge_mask[:, rev]
    dists = res.dist.cpu().numpy()
    return [
        SPGResult(u=int(us[k]), v=int(vs[k]), dist=int(dists[k]),
                  edge_ids=_edge_ids(mask[k]), d_top=INF)
        for k in range(b)
    ]


def bibfs_spg(graph: Graph, u: int, v: int, max_levels: int = 512,
              backend: str = "segment", device=None) -> SPGResult:
    return bibfs_spg_batch(graph, [u], [v], max_levels=max_levels,
                           backend=backend, device=device)[0]


# ---------------------------------------------------------------------------
# PPL — pruned path labelling (Algorithm 1)
# ---------------------------------------------------------------------------


class PPLIndex:
    """Pruned path labelling over *all* vertices in degree order.

    Labels are a dense (V, V) int64 matrix in vertex-order index space with
    INF for pruned entries (fine at baseline scales; the paper's point is
    that this family cannot scale, which the dense footprint makes vivid).
    Host numpy throughout; the graph may lie on any device.
    """

    def __init__(self, graph: Graph, store_parents: bool = False,
                 max_levels: int = 256):
        self.graph = graph
        self.store_parents = store_parents
        v = graph.n_vertices
        deg = graph.degrees().cpu().numpy()
        self.order = np.argsort(-deg, kind="stable").astype(np.int32)
        src = graph.src.cpu().numpy()
        dst = graph.dst.cpu().numpy()
        indptr = graph.indptr.cpu().numpy()
        self._src, self._dst, self._indptr = src, dst, indptr

        lab = np.full((v, v), INF, np.int64)  # (vertex, landmark-rank)
        parents: dict[tuple[int, int], list[int]] = {}
        for k, vk in enumerate(self.order):
            depth = np.full((v,), INF, np.int64)
            depth[vk] = 0
            frontier = np.zeros((v,), bool)
            frontier[vk] = True
            level = 0
            while frontier.any() and level < max_levels:
                f_idx = np.flatnonzero(frontier)
                # d_{L_{k-1}}(v_k, u) via already-built labels
                dq = (lab[f_idx, :] + lab[vk, None, :]).min(axis=1)
                dq = np.minimum(dq, INF)
                keep = dq >= depth[f_idx]          # label unless strictly covered
                expand = dq > depth[f_idx]         # expand only if strictly better
                labelled = f_idx[keep]
                lab[labelled, k] = depth[labelled]
                if store_parents and level > 0:
                    for uu in labelled:
                        s, e = indptr[uu], indptr[uu + 1]
                        nb = dst[s:e]
                        ps = nb[depth[nb] == depth[uu] - 1]
                        if ps.size:
                            parents[(int(uu), k)] = ps.tolist()
                nxt = np.zeros((v,), bool)
                for uu in f_idx[expand]:
                    s, e = indptr[uu], indptr[uu + 1]
                    nb = dst[s:e]
                    fresh = nb[depth[nb] == INF]
                    depth[fresh] = level + 1
                    nxt[fresh] = True
                frontier = nxt
                level += 1
        self.lab = lab
        self.parents = parents
        self.rank_to_vertex = self.order
        self.vertex_to_rank = np.empty((v,), np.int64)
        self.vertex_to_rank[self.order] = np.arange(v)

    def label_entries(self) -> int:
        return int((self.lab < INF).sum())

    def dist(self, u: int, v: int) -> int:
        return int(min(np.min(self.lab[u] + self.lab[v]), INF))

    def query(self, u: int, v: int) -> SPGResult:
        """Recursive SPG answering (§3.2), memoized over sub-queries.

        Each sub-query (a, b) splits at every hub r with
        ``lab[a, r] + lab[b, r] == d`` (and, with parents, walks their
        parent sets), as in the reference, then steps from a to every
        neighbour x with ``dist(x, b) == d - 1`` and solves (x, b).  The
        step makes the answer exact: every shortest path's first edge is
        emitted and its rest solved, with label distances (which are exact)
        as the test.  The reference has no step, and its labels do not
        cover every shortest path: a vertex reached at a depth equal to its
        label distance is labelled but not expanded, so the vertices behind
        it miss that hub.  Its answers then lack edges (2 of the 50 SPG edge
        slots of (298, 849) on ``barabasi_albert_graph(1000, 3, seed=0)``);
        the step's edges are its edges plus exactly the missing ones.
        """
        edges: set[tuple[int, int]] = set()
        memo: set[tuple[int, int]] = set()

        def solve(a: int, b: int) -> None:
            if a == b:
                return
            key = (min(a, b), max(a, b))
            if key in memo:
                return
            memo.add(key)
            d = int(min(np.min(self.lab[a] + self.lab[b]), INF))
            if d >= INF:
                return
            if d == 1:
                edges.add(key)
                return
            sums = self.lab[a] + self.lab[b]
            ranks = np.flatnonzero(sums == d)
            for k in ranks:
                r = int(self.rank_to_vertex[k])
                if r in (a, b):
                    continue
                if self.store_parents:
                    self._emit_parent_walk(a, k, edges)
                    self._emit_parent_walk(b, k, edges)
                solve(a, r)
                solve(b, r)
            for x in self._dst[self._indptr[a]:self._indptr[a + 1]].tolist():
                if x != a and self.dist(x, b) == d - 1:
                    edges.add((min(a, x), max(a, x)))
                    solve(x, b)

        solve(u, v)
        d = self.dist(u, v)
        return SPGResult(u=u, v=v, dist=d,
                         edge_ids=self._edges_to_ids(edges), d_top=INF)

    def _emit_parent_walk(self, x: int, rank: int, edges: set) -> None:
        """ParentPPL accelerator: emit tree edges along stored parent sets."""
        stack = [x]
        seen = {x}
        r = int(self.rank_to_vertex[rank])
        while stack:
            cur = stack.pop()
            if self.lab[cur, rank] == 1:
                edges.add((min(cur, r), max(cur, r)))
                continue
            for p in self.parents.get((cur, rank), ()):
                edges.add((min(cur, p), max(cur, p)))
                if p not in seen:
                    seen.add(p)
                    stack.append(p)

    def _edges_to_ids(self, edges: set[tuple[int, int]]) -> np.ndarray:
        src, dst = self._src, self._dst
        n = self.graph.n_vertices
        if not edges:
            return np.zeros((0,), np.int64)
        es = np.asarray(sorted(edges), np.int64)
        keys = src.astype(np.int64) * n + dst
        order = np.argsort(keys)
        want = np.concatenate([es[:, 0] * n + es[:, 1], es[:, 1] * n + es[:, 0]])
        pos = np.searchsorted(keys[order], want)
        pos = np.clip(pos, 0, keys.size - 1)
        ids = order[pos]
        ok = keys[ids] == want
        return np.unique(ids[ok])

    def memory_bytes(self) -> int:
        """Label entries at 5 bytes (32-bit landmark id + 8-bit distance, the
        paper's accounting), plus 4 bytes per stored parent."""
        total = self.label_entries() * 5
        if self.store_parents:
            total += sum(4 * len(p) for p in self.parents.values())
        return total
