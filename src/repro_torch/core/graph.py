"""Fixed-shape CSR graph, builders and synthetic generators (PyTorch).

Counterpart of ``repro.core.graph``.  The graph is an unweighted,
undirected edge set stored as a symmetrized directed edge list (every
undirected edge in both orientations) plus a CSR ``indptr``, all int32
tensors on one device.  Canonicalization, padding and the generators are
host-side numpy exactly as in the reference, and the generators draw from
``np.random.default_rng(seed)``, so both packages build the same graph,
with the same edge-slot ids, from a seed.

Every builder takes ``device=``: ``None`` means the CUDA card and raises
when there is none; pass ``device="cpu"`` to run the plain PyTorch path on
the host.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Distance sentinel.  Small enough that INF + INF + INF fits int32 with room
# to spare, large enough to exceed any real distance.
INF = 1 << 20


def resolve_device(device=None) -> torch.device:
    """The device an entry point puts its tensors on: the CUDA card unless
    the caller names another; never a silent fall-back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path on the host")
        return torch.device("cuda")
    return torch.device(device)


class Graph(NamedTuple):
    """Symmetrized CSR graph. ``src``/``dst`` are sorted by ``src``."""

    indptr: torch.Tensor  # (V+1,) int32
    src: torch.Tensor     # (E,) int32
    dst: torch.Tensor     # (E,) int32

    @property
    def n_vertices(self) -> int:
        return int(self.indptr.shape[0]) - 1

    @property
    def n_edges(self) -> int:
        """Directed edge-slot count (2x undirected edges + padding)."""
        return int(self.src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.src.device

    def to(self, device) -> "Graph":
        return Graph(*(t.to(device) for t in self))

    def degrees(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]

    def hub_mask(self, n_hubs: int | None = None,
                 top_frac: float = 0.01) -> np.ndarray:
        """Host-side ``(V,)`` bool mask of the top-degree vertices (self-loop
        padding excluded from the degree count; ties break by vertex id).
        ``n_hubs`` picks an explicit count, otherwise the top ``top_frac``
        of vertices (at least one)."""
        from .frontier import hub_split

        if n_hubs is None:
            n_hubs = max(1, int(self.n_vertices * top_frac))
        return hub_split(self, int(n_hubs)).is_hub


def from_edges(
    edges: np.ndarray,
    n_vertices: int,
    *,
    pad_vertices_to: int | None = None,
    pad_edges_to: int | None = None,
    device=None,
) -> Graph:
    """Build a symmetrized ``Graph`` from an (M, 2) undirected edge array.

    Self-loops and duplicate edges are dropped.  The canonical order is the
    reference's: unique ``lo * V + hi`` keys, both orientations, a stable
    argsort by ``src``.  Optional padding appends isolated vertices and
    self-loop edge slots on the last vertex.
    """
    dev = resolve_device(device)
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    edges = edges[edges[:, 0] != edges[:, 1]]
    if edges.size:
        lo = np.minimum(edges[:, 0], edges[:, 1])
        hi = np.maximum(edges[:, 0], edges[:, 1])
        canon = np.unique(lo * np.int64(n_vertices) + hi)
        lo = (canon // n_vertices).astype(np.int32)
        hi = (canon % n_vertices).astype(np.int32)
        s = np.concatenate([lo, hi])
        d = np.concatenate([hi, lo])
    else:
        s = np.zeros((0,), np.int32)
        d = np.zeros((0,), np.int32)

    n_v = n_vertices
    if pad_vertices_to is not None:
        if pad_vertices_to < n_vertices:
            raise ValueError("pad_vertices_to < n_vertices")
        n_v = pad_vertices_to
    n_e = s.shape[0]
    if pad_edges_to is not None:
        if pad_edges_to < n_e:
            raise ValueError(f"pad_edges_to={pad_edges_to} < {n_e}")
        pad_v = n_v - 1  # isolated when padding vertices were requested
        extra = pad_edges_to - n_e
        s = np.concatenate([s, np.full((extra,), pad_v, np.int32)])
        d = np.concatenate([d, np.full((extra,), pad_v, np.int32)])

    order = np.argsort(s, kind="stable")
    s = s[order].astype(np.int32)
    d = d[order].astype(np.int32)
    indptr = np.zeros((n_v + 1,), np.int64)
    indptr[1:] = np.bincount(s, minlength=n_v)
    indptr = np.cumsum(indptr).astype(np.int32)
    return Graph(*(torch.from_numpy(a).to(dev) for a in (indptr, s, d)))


def edge_set(graph: Graph) -> np.ndarray:
    """Host-side ``(M, 2)`` canonical undirected edge array (lo < hi, sorted)
    of the real edges; padding self-loops are excluded."""
    s = graph.src.cpu().numpy().astype(np.int64)
    d = graph.dst.cpu().numpy().astype(np.int64)
    real = s < d
    return np.stack([s[real], d[real]], axis=1)


# ---------------------------------------------------------------------------
# Generators (host-side numpy, the reference's draws from the same seed).
# ---------------------------------------------------------------------------

def gnp_random_graph(n: int, avg_degree: float, seed: int, **kw) -> Graph:
    """Erdos-Renyi-ish sparse sampler: E = n*avg_degree/2 sampled pairs."""
    rng = np.random.default_rng(seed)
    m = max(1, int(n * avg_degree / 2))
    edges = rng.integers(0, n, size=(m, 2), dtype=np.int64)
    return from_edges(edges, n, **kw)


def barabasi_albert_graph(n: int, m: int, seed: int, **kw) -> Graph:
    """Preferential-attachment generator (hub-heavy degree skew)."""
    rng = np.random.default_rng(seed)
    m = max(1, min(m, n - 1))
    targets = list(range(m))
    repeated: list[int] = []
    edges = []
    for v in range(m, n):
        for t in targets:
            edges.append((v, t))
        repeated.extend(targets)
        repeated.extend([v] * m)
        # sample next targets from the degree-weighted multiset
        idx = rng.integers(0, len(repeated), size=(m,))
        targets = list({repeated[i] for i in idx})
        while len(targets) < m:
            targets.append(int(rng.integers(0, v + 1)))
    return from_edges(np.asarray(edges, np.int64), n, **kw)


def random_regular_graph(n: int, degree: int, seed: int, **kw) -> Graph:
    """~degree-regular random graph via unions of random matchings."""
    rng = np.random.default_rng(seed)
    edges = []
    for _ in range(max(1, degree // 2)):
        perm = rng.permutation(n)
        edges.append(np.stack([np.arange(n), perm], axis=1))
    return from_edges(np.concatenate(edges), n, **kw)


def ring_of_cliques(n_cliques: int, clique_size: int, seed: int = 0, **kw) -> Graph:
    """Flat-degree, long-diameter stress regime."""
    edges = []
    n = n_cliques * clique_size
    for c in range(n_cliques):
        base = c * clique_size
        for i in range(clique_size):
            for j in range(i + 1, clique_size):
                edges.append((base + i, base + j))
        nxt = ((c + 1) % n_cliques) * clique_size
        edges.append((base, nxt))
    return from_edges(np.asarray(edges, np.int64), n, **kw)


def grid_graph(rows: int, cols: int, **kw) -> Graph:
    edges = []
    for r in range(rows):
        for c in range(cols):
            v = r * cols + c
            if c + 1 < cols:
                edges.append((v, v + 1))
            if r + 1 < rows:
                edges.append((v, v + cols))
    return from_edges(np.asarray(edges, np.int64), rows * cols, **kw)


def largest_connected_component(edges: np.ndarray, n: int) -> tuple[np.ndarray, int]:
    """Relabel ``edges`` to the largest connected component: ``(edges in
    the component, renumbered 0..n_kept-1, n_kept)``.  Host-side union-find,
    as in the reference."""
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    parent = np.arange(n)

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for a, b in edges:
        ra, rb = find(int(a)), find(int(b))
        if ra != rb:
            parent[ra] = rb
    roots = np.array([find(i) for i in range(n)])
    vals, counts = np.unique(roots, return_counts=True)
    big = vals[np.argmax(counts)]
    keep = roots == big
    remap = -np.ones(n, np.int64)
    remap[keep] = np.arange(keep.sum())
    mask = keep[edges[:, 0]] & keep[edges[:, 1]]
    return remap[edges[mask]], int(keep.sum())


def select_landmarks(graph: Graph, n_landmarks: int) -> np.ndarray:
    """Highest-degree vertices, ties by vertex id (paper §6.1)."""
    deg = graph.degrees().cpu().numpy()
    order = np.argsort(-deg, kind="stable")
    return np.sort(order[:n_landmarks]).astype(np.int32)
