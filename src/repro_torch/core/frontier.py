"""The frontier engine: the one level-synchronous BFS relay that every phase
of QbS runs on.  Counterpart of ``repro.core.frontier``.

Every phase (offline labelling, the sketch-bounded bidirectional search,
the reverse and recover sweeps, the one-sided landmark BFS) is the same
operation: propagate per-edge boolean messages into their destinations,

    next[k, w] = OR_{e : dst[e] = w}  values[k, src[e]] & mask[e]

Backends:

* ``segment`` — the edge-list push relay: gather by ``src``, then an int
  ``scatter_reduce(..., "amax")`` into a zeroed accumulator keyed by
  ``dst`` (``segment_or``).  Default.
* ``csr``     — the pull relay over the src-sorted (CSR-row) layout:
  ``next[w] = OR_{e in row w} values[dst[e]]``, valid because the edge set
  and any baked mask are symmetric.  The key (``src``) is sorted, so each
  row is a contiguous run of edges and the OR is a count over the run: an
  int32 prefix sum of the messages read at the row boundaries (count > 0),
  with no atomics (``csr_or``).  ``block_size`` cuts the edge list into
  fixed blocks (padded with key = V, gather = 0) to bound the ``(K, E)``
  message temporary; the blocks OR into a ``(K, V + 1)`` accumulator.
* ``hybrid``  — degree split: the dense hub-hub block (bit-packed words)
  and the sparse tail (the other edges, as CSR rows ``tail_ptr`` /
  ``tail_col``), ORed.  Both run in one call of ``kernels.ops.hybrid_relay``:
  the fused CUDA kernel on the card, a pull over the tail's rows like
  ``csr``'s plus the hub block's expansion
  (``bitmap_expand_packed``, which the reference reaches with
  ``use_pallas=True``), with no ``(K, E)`` message temporary; its plain
  version (``csr_or`` over the rows, ``bitmap_expand_packed_ref``) on the
  CPU.

The static G- edge mask is baked in at build time (``make_relay``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..kernels import ops
from ..kernels.ref import csr_or
from .graph import INF, Graph
from .packing import pack_bits

BACKENDS = ("segment", "csr", "hybrid")


def segment_or(messages: torch.Tensor, segment_ids: torch.Tensor,
               num_segments: int) -> torch.Tensor:
    """OR-reduce per-edge boolean messages ``(K, E)`` into ``(K, N)``: an int
    ``amax`` scatter into a zero-initialised accumulator, then ``> 0``, so
    an empty segment comes out False (the reference's ``segment_max`` fills
    it with the dtype minimum)."""
    k = messages.shape[0]
    acc = torch.zeros((k, num_segments), dtype=torch.int32,
                      device=messages.device)
    idx = segment_ids.to(torch.int64).expand(k, -1)
    acc.scatter_reduce_(1, idx, messages.to(torch.int32), "amax")
    return acc > 0


class FrontierEngine:
    """Per-graph relay engine over device tensors in ``arrays``."""

    def __init__(self, arrays: dict[str, Any], *, backend: str,
                 n_vertices: int, n_edges: int, block_size: int = 0):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")
        self.arrays = arrays
        self.backend = backend
        self.n_vertices = n_vertices
        self.n_edges = n_edges
        self.block_size = block_size

    def relay(self, values: torch.Tensor) -> torch.Tensor:
        """``(K, V) -> (K, V)`` (or ``(V,) -> (V,)``) with the build-time edge
        mask applied: next[k, w] = OR over unmasked edges (x, w) of
        values[k, x]."""
        squeeze = values.ndim == 1
        f = values[None] if squeeze else values
        if self.backend == "segment":
            out = self._relay_segment(f)
        elif self.backend == "csr":
            out = self._relay_csr(f)
        else:
            out = self._relay_hybrid(f)
        return out[0] if squeeze else out

    def _relay_segment(self, f: torch.Tensor) -> torch.Tensor:
        msgs = f[:, self.arrays["src"]]
        mask = self.arrays.get("mask")
        if mask is not None:
            msgs = msgs & mask
        return segment_or(msgs, self.arrays["dst"], self.n_vertices)

    def _relay_csr(self, f: torch.Tensor) -> torch.Tensor:
        # pull over the src-sorted rows: by edge-set and mask symmetry, OR
        # over out-neighbours == OR over in-neighbours
        gather = self.arrays["csr_gather"]    # dst column, padded to blocks
        mask = self.arrays.get("csr_mask")
        bounds = self.arrays["csr_bounds"]    # (n_blocks, V + 2) row starts
        v = self.n_vertices
        b = self.block_size or gather.shape[0]
        acc = torch.zeros((f.shape[0], v + 1), dtype=torch.bool, device=f.device)
        for i in range(bounds.shape[0]):
            sl = slice(i * b, (i + 1) * b)
            msgs = f[:, gather[sl]]
            if mask is not None:
                msgs = msgs & mask[sl]
            acc |= csr_or(msgs, bounds[i])
        return acc[:, :v]

    def _relay_hybrid(self, f: torch.Tensor) -> torch.Tensor:
        a = self.arrays
        return ops.hybrid_relay(f.contiguous(), a["tail_ptr"], a["tail_col"],
                                a["hub_ids"], a["adj_hh_words"])


def bfs_depths(engine: FrontierEngine, root, max_levels: int,
               bound=None) -> torch.Tensor:
    """Level-synchronous single-source BFS: ``(V,)`` int32 depths, ``INF`` =
    unreached; ``bound`` truncates the expansion at that depth.  One row of
    ``bfs_depths_batch``, whose per-row stopping rule is the reference's
    scalar one."""
    dev = engine.arrays["src"].device
    roots = torch.as_tensor(root, dtype=torch.int32, device=dev).reshape(1)
    bounds = None if bound is None else \
        torch.as_tensor(bound, dtype=torch.int32, device=dev).reshape(1)
    return bfs_depths_batch(engine, roots, max_levels, bounds=bounds)[0]


def bfs_depths_batch(engine: FrontierEngine, roots: torch.Tensor,
                     max_levels: int,
                     bounds: torch.Tensor | None = None) -> torch.Tensor:
    """Batched level-synchronous BFS: ``(B,)`` roots -> ``(B, V)`` int32
    depths, ``INF`` = unreached.  One relay per level serves every row.
    ``bounds`` ``(B,)`` truncates each row at its own depth: row k expands
    only while ``level < bounds[k]``.  A row that stops is frozen while the
    others go on, as under the reference's ``while_loop``."""
    b = roots.shape[0]
    dev = roots.device
    rows = torch.arange(b, device=dev)
    depth = torch.full((b, engine.n_vertices), INF, dtype=torch.int32, device=dev)
    depth[rows, roots.to(torch.int64)] = 0
    alive = torch.ones((b,), dtype=torch.bool, device=dev)
    level = 0
    while level < max_levels:
        act = alive if bounds is None else alive & (level < bounds)
        if not bool(act.any()):
            break
        msg = engine.relay((depth == level) & act[:, None])
        new = msg & (depth == INF)
        alive = torch.where(act, new.any(dim=1), alive)
        depth = torch.where(new, level + 1, depth)
        level += 1
    return depth


class HubSplit(NamedTuple):
    """Host-side degree split (see ``Graph.hub_split``)."""

    hub_ids: np.ndarray    # (H,) int32, ascending vertex ids
    is_hub: np.ndarray     # (V,) bool
    hub_pos: np.ndarray    # (V,) int64 vertex -> hub-block row, -1 otherwise
    adj_hh: np.ndarray     # (H, H) bool dense hub-hub adjacency
    hub_edge: np.ndarray   # (E,) bool: both endpoints are hubs (excl. loops)


def hub_split(graph: Graph, n_hubs: int | None = None) -> HubSplit:
    """The top-``n_hubs`` vertices by degree (self-loop padding excluded)
    form the dense hub block; host numpy, as in the reference."""
    src = graph.src.cpu().numpy()
    dst = graph.dst.cpu().numpy()
    v = graph.n_vertices
    real = src != dst
    deg = np.bincount(src[real], minlength=v)
    h = max(min(v, 128 if n_hubs is None else n_hubs), 1)
    order = np.argsort(-deg, kind="stable")
    hub_ids = np.sort(order[:h]).astype(np.int32)
    is_hub = np.zeros((v,), bool)
    is_hub[hub_ids] = True
    hub_pos = np.full((v,), -1, np.int64)
    hub_pos[hub_ids] = np.arange(h)
    hub_edge = real & is_hub[src] & is_hub[dst]
    adj = np.zeros((h, h), bool)
    adj[hub_pos[src[hub_edge]], hub_pos[dst[hub_edge]]] = True
    return HubSplit(hub_ids, is_hub, hub_pos, adj, hub_edge)


def make_relay(graph: Graph, *, backend: str = "segment",
               edge_mask: torch.Tensor | np.ndarray | None = None,
               n_hubs: int | None = None, block_size: int = 0) -> FrontierEngine:
    """Build a ``FrontierEngine`` on the graph's device.

    ``edge_mask`` is a static per-edge boolean (the G- mask); it must be
    symmetric, which any mask of the form ``f[src] & f[dst]`` is.  ``csr``
    and ``hybrid`` also need the edge set symmetric, which ``from_edges``
    guarantees.  ``n_hubs`` is read by ``hybrid`` only, ``block_size`` by
    ``csr`` only (0 = one block of every edge).
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")
    v, e = graph.n_vertices, graph.n_edges
    dev = graph.device
    arrays: dict[str, Any] = {"src": graph.src, "dst": graph.dst}
    if isinstance(edge_mask, torch.Tensor):
        edge_mask = edge_mask.cpu().numpy()
    mask_np = None if edge_mask is None else np.asarray(edge_mask).astype(bool)

    if backend == "segment":
        if mask_np is not None:
            arrays["mask"] = torch.from_numpy(mask_np).to(dev)
        return FrontierEngine(arrays, backend=backend, n_vertices=v, n_edges=e)

    if backend == "csr":
        gather, key, m = graph.dst, graph.src, mask_np
        if m is not None:
            m = torch.from_numpy(m).to(dev)
        pad = (-e) % block_size if block_size else 0
        if pad:
            gather = torch.cat([gather, gather.new_zeros((pad,))])
            key = torch.cat([key, key.new_full((pad,), v)])
            if m is not None:
                m = torch.cat([m, m.new_zeros((pad,))])
        # each block's row starts for rows 0..V (V = padding) and its end
        b = block_size or max(e, 1)
        rows = torch.arange(v + 2, dtype=key.dtype, device=dev)
        arrays["csr_bounds"] = torch.stack([
            torch.searchsorted(key[i:i + b].contiguous(), rows)
            for i in range(0, max(key.shape[0], 1), b)])
        arrays["csr_gather"] = gather
        if m is not None:
            arrays["csr_mask"] = m
        return FrontierEngine(arrays, backend=backend, n_vertices=v, n_edges=e,
                              block_size=block_size)

    # hybrid: degree split, dense hub block (mask baked in), tail as CSR rows
    src_np = graph.src.cpu().numpy()
    dst_np = graph.dst.cpu().numpy()
    split = hub_split(graph, n_hubs)
    adj = split.adj_hh.copy()
    keep_tail = ~split.hub_edge
    if mask_np is not None:
        dead = split.hub_edge & ~mask_np
        adj[split.hub_pos[src_np[dead]], split.hub_pos[dst_np[dead]]] = False
        keep_tail = keep_tail & mask_np
    arrays["hub_ids"] = torch.from_numpy(split.hub_ids).to(dev)
    # the hub-hub block lives bit-packed (int32 words); it is symmetric, so
    # row p also holds column p, which the kernel's pull reads
    arrays["adj_hh_words"] = pack_bits(torch.from_numpy(adj)).to(dev)
    # the tail is a subsequence of the src-sorted edge list, hence already
    # in row order: row w holds the tail edges (w, x), and by symmetry
    # OR over them equals OR over the edges (x, w) that the reference's
    # push relay reads
    tail_ptr = np.zeros((v + 1,), np.int64)
    np.cumsum(np.bincount(src_np[keep_tail], minlength=v), out=tail_ptr[1:])
    arrays["tail_ptr"] = torch.from_numpy(tail_ptr.astype(np.int32)).to(dev)
    arrays["tail_col"] = torch.from_numpy(dst_np[keep_tail].astype(np.int32)).to(dev)
    return FrontierEngine(arrays, backend=backend, n_vertices=v, n_edges=e)
