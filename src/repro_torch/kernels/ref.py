"""Plain PyTorch versions of the hand-written kernels: the semantics each
kernel must reproduce bit for bit, and what a wrapper runs for a tensor on
the CPU.  Counterpart of ``repro.kernels.ref``."""
from __future__ import annotations

import weakref

import torch

from .. import trace
from ..core.graph import INF
from ..core.packing import pack_bits, unpack_bits, widen_dist


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


def _attach_lists(label_dist: torch.Tensor, src: torch.Tensor,
                  dst: torch.Tensor, lid: torch.Tensor):
    """The static edge lists the plain attach reads (int64 index lists):
    ``dec[r]`` = ``(eid, src, dst)`` of the G- edges whose label toward
    landmark r decrements along the edge (``ld[dst, r] == ld[src, r] - 1``,
    dst labelled); ``at_src``/``at_dst`` = ``(eid, r, other)`` of the edges
    whose src (resp. dst) is landmark r."""
    ld = widen_dist(label_dist)
    src64 = src.to(torch.int64)
    dst64 = dst.to(torch.int64)
    is_landmark = lid >= 0
    gminus_e = (~is_landmark[src64]) & (~is_landmark[dst64])
    dec = []
    for r in range(ld.shape[1]):
        ld_s = ld[src64, r]
        ld_d = ld[dst64, r]
        eid = torch.nonzero(gminus_e & (ld_d < INF) & (ld_d == ld_s - 1))[:, 0]
        dec.append((eid, src64[eid], dst64[eid]))

    def at(end, other):
        eid = torch.nonzero(is_landmark[end])[:, 0]
        return eid, lid[end[eid]].to(torch.int64), other[eid]

    return tuple(dec), at(src64, dst64), at(dst64, src64)


# label_dist's id -> (src, dst, lid, lists); an entry goes when its
# label_dist does, so an id is never reused while its entry stands
_ATTACH_LISTS: dict[int, tuple] = {}


def attach_lists(label_dist: torch.Tensor, src: torch.Tensor,
                 dst: torch.Tensor, lid: torch.Tensor):
    """``_attach_lists``, built at the plain attach's first call on a label
    table and kept while the table lives (rebuilt if the same table comes
    with another graph).  Only the plain version reads them: the kernels
    test the decrement from the label rows."""
    key = id(label_dist)
    hit = _ATTACH_LISTS.get(key)
    if hit is None or any(a is not b for a, b in zip(hit, (src, dst, lid))):
        if hit is None:
            weakref.finalize(label_dist, _ATTACH_LISTS.pop, key, None)
        hit = _ATTACH_LISTS[key] = (src, dst, lid,
                                    _attach_lists(label_dist, src, dst, lid))
    return hit[3]


def pack_on(on: torch.Tensor) -> torch.Tensor:
    """(R, B, V) bool -> the kernels' (V, ceil(B / 32), R) int32 words: bit
    ``b % 32`` of word ``[x, b // 32, r]`` is ``on[r, b, x]``."""
    return pack_bits(on.permute(2, 0, 1)).transpose(1, 2).contiguous()


def unpack_on(words: torch.Tensor, b: int) -> torch.Tensor:
    """(V, W, R) int32 words -> (R, b, V) bool (inverse of ``pack_on``)."""
    return unpack_bits(words.transpose(1, 2), b).permute(1, 2, 0)


def side_attach_ref(depth: torch.Tensor, side_land: torch.Tensor,
                    label_dist: torch.Tensor, indptr: torch.Tensor,
                    src: torch.Tensor, dst: torch.Tensor, lid: torch.Tensor,
                    max_chain: int, out: torch.Tensor | None = None):
    """Component (i)/(ii) of the recover search for one side: edges of
    landmark-free shortest t->r paths for every sketch edge (r, t), one
    landmark at a time, over the label-decrement edge lists (built at the
    first call, ``attach_lists``; ``indptr`` is the kernels' and unused
    here).

    Returns ``(edge_mask (B, E), on)`` with ``on`` packed as the kernels'
    words (``pack_on``), where ``on[r, b, x]`` certifies x on such a path
    for query b; with ``out`` the edges are ORed into it and it is
    returned.  The anchor-chain closure runs one shared loop over every
    (landmark, row) column: a column that has converged is a fixed point of
    the step, and every column still moving has taken the same number of
    steps, so the shared ``it < max_chain`` cap stops each one where its own
    loop would."""
    from ..core.frontier import segment_or   # core.frontier imports this module

    dec, at_src, at_dst = attach_lists(label_dist, src, dst, lid)
    ld = widen_dist(label_dist)                      # (V, R)
    n_r = ld.shape[1]
    b, n_vertices = depth.shape
    reached = depth < INF

    # pointwise certificate: G- BFS prefix + label suffix == sigma
    on = torch.empty((n_r, b, n_vertices), dtype=torch.bool, device=depth.device)
    for r in range(n_r):
        ld_r = ld[:, r][None, :]
        sigma = side_land[:, r:r + 1]
        on[r] = (ld_r < INF) & reached & (sigma < INF) & (depth + ld_r == sigma)

    # anchor-chain closure beyond the explored ball (paper's Z-walk): extend
    # along label-decrement edges in G- (a per-edge message, so it scatters)
    it = 0
    changed = True
    while changed and it < max_chain:
        moved = torch.zeros((), dtype=torch.bool, device=depth.device)
        for r in range(n_r):
            _, e_src, e_dst = dec[r]
            grown = segment_or(on[r][:, e_src], e_dst, n_vertices)
            moved |= (grown & ~on[r]).any()
            on[r] |= grown
        changed = bool(moved)   # one host sync per closure step
        it += 1
        trace.count("search.closure_steps")
        trace.count("search.host_syncs")

    # interior edges: both endpoints certified, label distance decrements
    e = src.shape[0]
    interior = torch.zeros((b, e), dtype=torch.bool, device=depth.device)
    for r, (eid, e_src, e_dst) in enumerate(dec):
        interior[:, eid] |= on[r][:, e_src] & on[r][:, e_dst]

    # final hops into the landmark (both orientations of the same edge)
    def hop(at):
        eid, r_idx, other = at
        hops = torch.zeros((b, e), dtype=torch.bool, device=depth.device)
        near = ld[other, r_idx] == 1
        hops[:, eid] = on[r_idx, :, other].T & near[None, :]
        return hops

    edges = interior | hop(at_dst) | hop(at_src)
    if out is not None:
        edges = out.bitwise_or_(edges)
    return edges, pack_on(on)


def sharded_attach_ref(mesh, halo, inp, max_chain: int) -> list:
    """Phase E1 of ``core.sharded.general_lane`` on per-shard lists
    (``attach_sharded.AttachInputs``): for each landmark, the label-decrement
    edges, the hops into and out of it (three ``nonzero``s per shard), the
    pointwise certificate of the 2B rows, the anchor-chain closure over the
    decrement edges with one ``halo`` exchange per step until no shard moves
    or ``max_chain`` steps, and the certified edges ORed into a ``(2B, E)``
    block.  Returns each shard's ``(B, E)`` bool, row ``b`` ORed with row
    ``b + B``."""
    from ..core.frontier import segment_or   # core.frontier imports this module

    n_shards = mesh.n_shards
    b2, r = inp.sigma[0].shape
    vloc = inp.labels[0].shape[0]
    dst_l = inp.dst_l
    rec2 = [torch.zeros((b2, d.shape[0]), dtype=torch.bool, device=d.device)
            for d in dst_l]
    for ri in range(r):
        dec, hin, hout, on = [], [], [], []
        for s in range(n_shards):
            ls_e = inp.label_src[s][:, ri]
            ld_e = inp.label_dst[s][:, ri]
            # the label-decrement edges carry the chain and the interior
            # edges; hops into / out of landmark ri are local subsets
            dec.append(torch.nonzero(inp.gm_e[s] & (ld_e == ls_e - 1)
                                     & (ld_e < INF))[:, 0])
            hin.append(torch.nonzero((inp.dst_lid[s] == ri) & (ls_e == 1))[:, 0])
            hout.append(torch.nonzero((inp.src_lid[s] == ri) & (ld_e == 1))[:, 0])
            trace.count("sharded.host_syncs", 3)
            lcol = torch.cat([inp.labels[s][:, ri],
                              torch.full((1,), INF, dtype=torch.int32,
                                         device=ls_e.device)])[None, :]
            sg = inp.sigma[s][:, ri][:, None]
            sides = inp.sides[s]
            on.append((sides < INF) & (lcol < INF) & (sides + lcol == sg)
                      & (sg < INF))
        for _ in range(max_chain):
            bits = halo([o[:, :vloc] for o in on], dec)
            moved = []
            for s in range(n_shards):
                grown = on[s] | segment_or(bits[s], dst_l[s][dec[s]], vloc + 1)
                moved.append((grown != on[s]).any().to(torch.int32)[None])
                on[s] = grown
            trace.count("sharded.host_syncs")
            if not bool(mesh.psum(moved)[0]):
                break   # a fixed point: the remaining steps change nothing
        both = [torch.cat([a, c]) for a, c in zip(dec, hin)]
        bits = halo([o[:, :vloc] for o in on], both)
        for s in range(n_shards):
            k = dec[s].shape[0]
            interior = bits[s][:, :k] & on[s][:, dst_l[s][dec[s]]]
            rec2[s][:, dec[s]] |= interior
            rec2[s][:, hin[s]] |= bits[s][:, k:]
            rec2[s][:, hout[s]] |= on[s][:, dst_l[s][hout[s]]]
    return [x[:b2 // 2] | x[b2 // 2:] for x in rec2]
