"""Inputs for the side attach (``kernels.ops.side_attach``) and a model of
its CUDA kernels in PyTorch, shared by the CPU tests and the card's tests.
Imports neither JAX nor the JAX package.

``synthetic`` draws arbitrary arguments: a random symmetric graph with
random landmarks and random packed labels, near the dtype's sentinel when
asked (so a finite label beside the sentinel would decrement into it if the
sentinel were read as a number).  ``real`` runs the port's own labelling,
sketch and bidirectional BFS on a small graph, with BFS balls cut short by
``max_levels`` so that the anchor-chain closure has work to do.

``kernel_model`` computes what ``csrc/side_attach.cu`` computes, the way it
computes it: packed labels tested against the sentinel before any sum,
(V, W, R) words, the certificate per word, the activity bitmap (a bit per
vertex whose row holds a set bit, never cleared), the closure as Jacobi
steps over ``attach.closure_segments``' warps pulling only active CSR
neighbours with the decrement tested from the label rows, and the edge pass
per slot, skipping slots with neither end active.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import graph as tg
from repro_torch.core.graph import INF
from repro_torch.core.packing import pack_bits, pack_dist, sentinel_of, take, widen_dist
from repro_torch.kernels.attach import SEG_SLOTS, closure_segments

NP_DTYPE = {torch.uint8: np.uint8, torch.uint16: np.uint16}


def _args(graph, label_dist, lid, depth, sigma):
    return dict(depth=depth, side_land=sigma, label_dist=label_dist,
                indptr=graph.indptr, src=graph.src, dst=graph.dst, lid=lid)


def synthetic(seed: int, b: int, *, v: int = 90, m: int = 260, r: int = 6,
              dtype=torch.uint8, near_sentinel: bool = False, device="cpu"):
    """Arbitrary arguments of ``ops.side_attach`` (a dict of tensors)."""
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, v, size=(m, 2))
    hub = rng.integers(0, v)   # joined to every vertex: a row of 3 segments
    edges = np.concatenate([edges, np.stack([np.full(v, hub), np.arange(v)], 1)])
    graph = tg.from_edges(edges, v, pad_edges_to=None, device=device)
    lms = rng.choice(v, size=r, replace=False)
    lid = np.full((v,), -1, np.int32)
    lid[lms] = np.arange(r, dtype=np.int32)
    sent = sentinel_of(dtype)
    base = sent - 4 if near_sentinel else 1
    lab = base + rng.integers(0, 4, size=(v, r))
    lab = np.where(rng.random((v, r)) < 0.2, INF, lab)
    lab[lms, np.arange(r)] = 0
    depth = rng.integers(0, 3, size=(b, v))
    depth = np.where(rng.random((b, v)) < 0.6, INF, depth)
    # sigma from a vertex each row holds, so some certificates hold
    pick = rng.integers(0, v, size=(b, r))
    rows = np.arange(b)[:, None]
    sigma = np.where(depth[rows, pick] < INF, depth[rows, pick], 0) \
        + np.where(lab[pick, np.arange(r)] < INF, lab[pick, np.arange(r)], 0)
    sigma = np.where(rng.random((b, r)) < 0.2, INF, sigma)
    label_dist = pack_dist(lab.astype(np.int32), NP_DTYPE[dtype], device=device)
    t = lambda a: torch.as_tensor(a.astype(np.int32), device=device)  # noqa: E731
    return _args(graph, label_dist, t(lid), t(depth), t(sigma))


def real(b: int, *, max_levels: int = 2, dtype=torch.uint8, device="cpu",
         seed: int = 3):
    """``ops.side_attach``'s arguments as ``recover_search`` passes them (u
    side) on a 150-vertex Barabasi-Albert graph with 6 landmarks."""
    from repro_torch.core import search as ts
    from repro_torch.core.labelling import build_labelling
    from repro_torch.core.sketch import compute_sketch_batch

    graph = tg.barabasi_albert_graph(150, 2, seed=seed, device=device)
    scheme = build_labelling(graph, tg.select_landmarks(graph, 6), device=device)
    ctx = ts.make_search_context(graph, scheme)
    label_dist = ctx.label_dist
    if dtype == torch.uint16:
        label_dist = pack_dist(widen_dist(label_dist), np.uint16)
    rng = np.random.default_rng(seed)
    non = np.flatnonzero(~scheme.is_landmark.cpu().numpy())
    us = torch.as_tensor(rng.choice(non, b), dtype=torch.int32, device=device)
    vs = torch.as_tensor(rng.choice(non, b), dtype=torch.int32, device=device)
    packed = ts.pack_labelling(scheme)
    sk = compute_sketch_batch(take(packed.label_dist, us.long()),
                              take(packed.label_dist, vs.long()),
                              packed.meta_w, packed.meta_dist)
    q = ts.Query(u=us, v=vs, d_top=sk.d_top, du_land=sk.du_land,
                 dv_land=sk.dv_land, meta_edge=sk.meta_edge,
                 d_star_u=sk.d_star_u, d_star_v=sk.d_star_v)
    depth_u = ts.bidirectional_bfs(ctx, q, graph.n_vertices, max_levels)[0]
    return _args(graph, label_dist, ctx.lid, depth_u, sk.du_land)


def kernel_model(depth, side_land, label_dist, indptr, src, dst, lid,
                 max_chain, out=None):
    """``(edge_mask (B, E), on (V, W, R) int32 words, steps)`` as the
    kernels compute them (see the module note)."""
    sent = sentinel_of(label_dist.dtype)
    ld = label_dist.to(torch.int64)                  # raw packed values
    fin = ld != sent
    b = depth.shape[0]
    lm = lid >= 0

    # certificate: sigma INF -> -1 (no sum reaches it); sentinel never summed
    s = torch.where(side_land < INF, side_land, -1).to(torch.int64)
    d = depth.to(torch.int64)
    bits = (d[:, :, None] < INF) & fin[None] \
        & (d[:, :, None] + torch.where(fin, ld, 0)[None] == s[:, None, :])
    on = pack_bits(bits.permute(1, 2, 0)).transpose(1, 2).contiguous()
    act = (on != 0).flatten(1).any(dim=1)

    # closure: Jacobi steps, a warp per segment of a CSR row, ORing new bits
    # pulled from its active neighbours; act is set in place, as on the card
    seg_row, seg_beg = closure_segments(indptr)
    steps, changed = 0, True
    while changed and steps < max_chain:
        nxt = on.clone()
        changed = False
        for y, beg in zip(seg_row.tolist(), seg_beg.tolist()):
            if lm[y]:
                continue
            end = min(beg + SEG_SLOTS, int(indptr[y + 1]))
            xs = dst[beg:end].to(torch.int64)
            xs = xs[act[xs] & ~lm[xs]]
            if not xs.numel():
                continue
            dec = fin[y][None] & fin[xs] & (ld[y][None] + 1 == ld[xs])  # (slots, R)
            acc = torch.where(dec[:, None, :], on[xs], 0)  # (slots, W, R)
            acc = _or_reduce(acc, 0)
            fresh = acc & ~on[y]
            if bool((fresh != 0).any()):
                nxt[y] |= fresh
                act[y] = True
                changed = True
        on = nxt
        steps += 1

    # edge pass, a slot at a time (vectorised over slots); a slot with
    # neither end active contributes nothing
    x = src.to(torch.int64)
    y = dst.to(torch.int64)
    ax, ay = act[x], act[y]
    ox, oy = on[x], on[y]                             # (E, W, R)
    interior = (ax & ay & ~lm[x] & ~lm[y])[:, None] & fin[x] & fin[y] \
        & (ld[y] + 1 == ld[x])
    acc = _or_reduce(torch.where(interior[:, None, :], ox & oy, 0), 2)  # (E, W)
    e_idx = torch.arange(x.shape[0])
    rd = lid[y].to(torch.int64).clamp(min=0)
    rs = lid[x].to(torch.int64).clamp(min=0)
    hop_in = ax & lm[y] & (ld[x, rd] == 1)
    hop_out = ay & lm[x] & (ld[y, rs] == 1)
    acc |= torch.where(hop_in[:, None], ox[e_idx, :, rd], 0)
    acc |= torch.where(hop_out[:, None], oy[e_idx, :, rs], 0)
    shifts = torch.arange(32, dtype=torch.int32)
    edges = ((acc[:, :, None] >> shifts) & 1).reshape(x.shape[0], -1)[:, :b].T
    edges = edges.to(torch.bool).contiguous()
    if out is not None:
        edges = out | edges
    return edges, on, steps


def _or_reduce(words: torch.Tensor, dim: int) -> torch.Tensor:
    acc = words.select(dim, 0).clone()
    for i in range(1, words.shape[dim]):
        acc |= words.select(dim, i)
    return acc
