"""Plain PyTorch versions of the hand-written kernels: the semantics each
kernel must reproduce bit for bit, and what a wrapper runs for a tensor on
the CPU.  Counterpart of ``repro.kernels.ref``."""
from __future__ import annotations

import torch

from ..core.graph import INF
from ..core.packing import unpack_bits, widen_dist


def minplus_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Min-plus (tropical) product: C[m, n] = min_k (A[m, k] + B[k, n]).
    int32 inputs with INF sentinels (INF + INF stays far below 2**31)."""
    return (a[:, :, None] + b[None, :, :]).amin(dim=1)


def _budget(side_land: torch.Tensor) -> torch.Tensor:
    b = torch.where(side_land < INF, side_land - 1, -1).amax(dim=1)
    return torch.clamp(b, min=0).to(torch.int32)


def sketch_batch_ref(lu: torch.Tensor, lv: torch.Tensor, meta_w: torch.Tensor,
                     meta_dist: torch.Tensor, minplus=minplus_ref):
    """Sketches (Eq. 3, Definition 4.5) for rows ``lu``/``lv`` ``(B, R)``,
    packed or int32: ``(d_top, du_land, dv_land, meta_edge, d_star_u,
    d_star_v)`` in the order of ``core.sketch.SketchBatch``.  d_top runs
    through ``minplus`` (the plain version by default), the structural part
    as masked dense ops over R^2 / R^4."""
    lu = widen_dist(lu)
    lv = widen_dist(lv)
    meta_w = widen_dist(meta_w)
    meta_dist = widen_dist(meta_dist)

    # pi[b, r, r'] = delta_ur + d_M(r,r') + delta_r'v  (clamped to INF)
    pi = torch.clamp(lu[:, :, None] + meta_dist[None, :, :] + lv[:, None, :],
                     max=INF)
    # Eq. 3 as two chained min-plus contractions (min is monotone, so
    # clamping after the reduction matches the clamped-pi reduction)
    t = minplus(lu.contiguous(), meta_dist.contiguous())        # (B, R)
    d_top = torch.clamp((t + lv).amin(dim=1), max=INF)
    have = d_top < INF
    att = (pi == d_top[:, None, None]) & have[:, None, None]   # attaining pairs

    du_land = torch.where(att.any(dim=2), lu, INF)
    dv_land = torch.where(att.any(dim=1), lv, INF)

    # meta edge (i, j) is in the sketch iff it lies on a shortest meta path
    # between some attaining pair (r, r'):
    #   d_M(r,i) + w(i,j) + d_M(j,r') == d_M(r,r')
    cost = (meta_dist[:, :, None, None] + meta_w[None, :, :, None]
            + meta_dist.T[None, None, :, :])                    # (R, i, j, R')
    on_path = (cost == meta_dist[:, None, None, :]) \
        & (meta_w < INF)[None, :, :, None]
    # meta_edge[b,i,j] = any_{r,r'} att[b,r,r'] & on_path[r,i,j,r'] as a float
    # count (at most R^2, exact in f32; CUDA has no integer einsum)
    meta_edge = torch.einsum("brs,rijs->bij", att.to(torch.float32),
                             on_path.to(torch.float32)) > 0.5

    return (d_top.to(torch.int32), du_land.to(torch.int32),
            dv_land.to(torch.int32), meta_edge, _budget(du_land),
            _budget(dv_land))


def bitmap_expand_ref(frontier: torch.Tensor,
                      adjacency: torch.Tensor) -> torch.Tensor:
    """One level-synchronous BFS expansion over a dense adjacency block:
    next[r, w] = OR_v frontier[r, v] & adjacency[v, w], as the f32 OR-AND
    product thresholded at 0.5 (exact for 0/1 inputs)."""
    return (frontier.to(torch.float32) @ adjacency.to(torch.float32)) > 0.5


def bitmap_expand_packed_ref(frontier: torch.Tensor, adj_words: torch.Tensor,
                             n_cols: int) -> torch.Tensor:
    """next[r, w] = OR_v frontier[r, v] & bit(adj_words[v, w // 32], w % 32):
    unpack the words, then the f32 OR-AND product thresholded at 0.5 (exact
    for 0/1 inputs; the reference's ``_dense_or_matmul``)."""
    adj = unpack_bits(adj_words, n_cols)
    return (frontier.to(torch.float32) @ adj.to(torch.float32)) > 0.5


def csr_or(messages: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """OR-reduce per-edge boolean messages ``(K, B)`` whose segment key is
    sorted into ``(K, N)``: ``bounds`` ``(N + 1,)`` holds each segment's
    first edge (and B last).  A zero-led int32 prefix sum of the messages,
    read at the boundaries, counts each segment's true messages; an empty
    segment counts 0 and comes out False.  No atomics: the key is sorted."""
    k, b = messages.shape
    cs = torch.zeros((k, b + 1), dtype=torch.int32, device=messages.device)
    cs[:, 1:] = messages
    cs.cumsum_(dim=1)
    return (cs[:, bounds[1:]] - cs[:, bounds[:-1]]) > 0


def hybrid_relay_ref(f: torch.Tensor, tail_ptr: torch.Tensor,
                     tail_col: torch.Tensor, hub_ids: torch.Tensor,
                     adj_words: torch.Tensor) -> torch.Tensor:
    """The hybrid relay: next[k, w] = OR_{e in tail row w} f[k, tail_col[e]],
    ORed on the hub columns with the hub block's expansion of the hub
    frontier (``bitmap_expand_packed_ref``), from the same CSR rows and hub
    arrays the kernel reads."""
    out = csr_or(f[:, tail_col], tail_ptr)
    hubs = hub_ids.to(torch.int64)
    out[:, hubs] |= bitmap_expand_packed_ref(f[:, hubs], adj_words,
                                             hub_ids.shape[0])
    return out
