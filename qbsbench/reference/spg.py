"""The plain reference: exact shortest-path graphs by breadth-first search,
in plain PyTorch (CPU or CUDA), from the edge list alone.

For a pair (u, v) at distance d, an undirected edge {x, y} lies on some
shortest u-v path iff ``du[x] + 1 + dv[y] == d`` in one of its two
orientations, where du and dv are BFS distances from u and from v.

The answers name edges by *edge slot*, the layout the served answers use:
every undirected edge in both orientations, the slots ordered by source
vertex, and within one source first the edges whose other end is above it
(ascending), then those whose other end is below it (ascending).
``RefGraph`` derives that layout from the edge list itself.

Nothing here imports the program under test.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

UNREACHED = -1


class RefGraph:
    """Edge slots and a sparse adjacency worked out from an ``(M, 2)``
    undirected edge list (self-loops and duplicates dropped)."""

    def __init__(self, edges: np.ndarray, n_vertices: int, device="cpu"):
        dev = torch.device(device)
        e = torch.as_tensor(np.asarray(edges, np.int64).reshape(-1, 2), device=dev)
        e = e[e[:, 0] != e[:, 1]]
        lo = torch.minimum(e[:, 0], e[:, 1])
        hi = torch.maximum(e[:, 0], e[:, 1])
        key = torch.unique(lo * n_vertices + hi)          # sorted
        lo, hi = key // n_vertices, key % n_vertices
        s = torch.cat([lo, hi])
        d = torch.cat([hi, lo])
        _, order = torch.sort(s, stable=True)
        self.src = s[order]
        self.dst = d[order]
        self.n = int(n_vertices)
        self.device = dev
        crow = torch.zeros((self.n + 1,), dtype=torch.int64, device=dev)
        crow[1:] = torch.cumsum(torch.bincount(self.src, minlength=self.n), 0)
        with warnings.catch_warnings():   # "sparse CSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            self.adj = torch.sparse_csr_tensor(
                crow, self.dst, torch.ones_like(self.dst, dtype=torch.float32),
                (self.n, self.n), check_invariants=False)

    @property
    def n_slots(self) -> int:
        return int(self.src.shape[0])

    def degrees(self) -> torch.Tensor:
        return torch.bincount(self.src, minlength=self.n)

    def bfs(self, roots: torch.Tensor,
            blocked: torch.Tensor | None = None) -> torch.Tensor:
        """``(S,)`` roots -> ``(S, V)`` int32 hop distances, ``UNREACHED``
        where no path exists.  ``blocked`` ``(V,)`` bool: vertices the
        search never enters (a root is still its own start)."""
        roots = roots.to(self.device, torch.int64)
        s = roots.shape[0]
        cols = torch.arange(s, device=self.device)
        dist = torch.full((self.n, s), UNREACHED, dtype=torch.int32,
                          device=self.device)
        dist[roots, cols] = 0
        front = torch.zeros((self.n, s), dtype=torch.float32, device=self.device)
        front[roots, cols] = 1.0
        level = 0
        while True:
            new = (torch.sparse.mm(self.adj, front) > 0) & (dist == UNREACHED)
            if blocked is not None:
                new &= ~blocked[:, None]
            if not bool(new.any()):
                break
            level += 1
            dist[new] = level
            front = new.to(torch.float32)
        return dist.T.contiguous()

    def spg_masks(self, du: torch.Tensor, dv: torch.Tensor,
                  d: torch.Tensor) -> torch.Tensor:
        """``(Q, V)`` distances from the u's and from the v's and ``(Q,)``
        distances -> ``(Q, E)`` bool: the slots on some shortest path, in
        both orientations; empty where d is ``UNREACHED``."""
        a_s = du.index_select(1, self.src)
        a_d = du.index_select(1, self.dst)
        b_s = dv.index_select(1, self.src)
        b_d = dv.index_select(1, self.dst)
        dd = d[:, None]
        fwd = (a_s >= 0) & (b_d >= 0) & (a_s + 1 + b_d == dd)
        bwd = (a_d >= 0) & (b_s >= 0) & (a_d + 1 + b_s == dd)
        return (fwd | bwd) & (dd >= 0)


def answer_pairs(g: RefGraph, us: np.ndarray, vs: np.ndarray, *,
                 blocked: np.ndarray | None = None, sources: int = 256):
    """Exact answers for the pairs ``(us[i], vs[i])``: yields ``(i, dist,
    slots)`` per pair, ``dist`` ``UNREACHED`` for no path and ``slots`` the
    sorted int64 edge slots of its shortest-path graph.

    ``blocked`` (V,) bool: the control's variant, which answers on the
    graph without those vertices (used for pairs that avoid them).
    Pairs are taken in blocks of at most ``sources // 2``, so the
    distance rows of one block live at a time."""
    us = np.asarray(us, np.int64)
    vs = np.asarray(vs, np.int64)
    blk = torch.as_tensor(blocked, device=g.device) if blocked is not None else None
    rows = max(1, min(64, (1 << 27) // max(g.n_slots, 1)))
    half = max(1, sources // 2)
    for b0 in range(0, us.size, half):
        bu, bv = us[b0:b0 + half], vs[b0:b0 + half]
        ends, inv = np.unique(np.concatenate([bu, bv]), return_inverse=True)
        dist = g.bfs(torch.as_tensor(ends, device=g.device), blocked=blk)
        iu = torch.as_tensor(inv[:bu.size], device=g.device)
        iv = torch.as_tensor(inv[bu.size:], device=g.device)
        for r0 in range(0, bu.size, rows):
            du = dist.index_select(0, iu[r0:r0 + rows])
            dv = dist.index_select(0, iv[r0:r0 + rows])
            vcol = torch.as_tensor(bv[r0:r0 + rows], device=g.device)
            d = du.gather(1, vcol[:, None])[:, 0]
            nz = torch.nonzero(g.spg_masks(du, dv, d)).cpu().numpy()
            cuts = np.searchsorted(nz[:, 0], np.arange(1, d.shape[0]))
            per_row = np.split(nz[:, 1], cuts)
            for k, (dk, slots) in enumerate(zip(d.cpu().numpy().tolist(), per_row)):
                yield b0 + r0 + k, int(dk), slots
        del dist
