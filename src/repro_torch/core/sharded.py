"""Vertex-sharded QbS index: every serving lane answered from the
born-sharded tables.  Counterpart of ``repro.core.sharded``.

``distributed_build_sharded`` leaves the packed label table, the (R, V)
landmark-distance table and the CSR edge partition resident one vertex
block per device; ``ShardedIndex`` is the ``QbSIndex``-shaped facade that
serves from them without materializing a full table.  Its three lanes are
plain functions of one ``ShardRecord``, made once per index: the mesh, the
block geometry, each shard's edge blocks and landmarks, and the attach's
kernel tables (``make_attach_plan``).

* **General lane** (``general_lane``): sketch rows for (u, v) come from the
  owning shard (owned-else-INF, then ``pmin``); the sketch is computed
  once, on the mesh's first device, by one ``ops.sketch_batch`` call, and
  replicated; the sketch-bounded Bi-BFS and the reverse sweeps run
  ``frontier.segment_or`` on each shard's dst-owned edges with one
  bit-packed ``all_gather`` of the frontier per level (the halo exchange);
  the recover's attachments, every landmark at once, are
  ``kernels.ops.sharded_attach`` (kernels on the cards, with one all-gather
  of raw word tables per closure step).
  Edge-source label columns come from a transient gather of the packed
  table, so the resident footprint stays one block per device.
* **Landmark lanes** (``landmark_pair_lane`` / ``onesided_lane``): gather
  exactly the B packed rows of the landmark-distance table a chunk needs,
  then certify per local edge; the one-sided lane adds the
  distance-bounded BFS, sharded level by level.

Every lane ends in the same **scatter-symmetrize**: each shard's certified
edges land in the canonical ``(B, n_edges)`` mask at their global slot and
at its reverse slot.  A directed edge is dst-owned by exactly one shard, so
the union equals the replicated path's ``mask | mask[:, rev_edge]``.

Answers come back on ``mesh.devices[0]``.  Every loop's stop test and the
Bi-BFS side choice read values reduced over all shards, so every shard runs
the same levels.  Loops the reference runs a fixed number of times (the
reverse sweeps, the recover chains) stop early only where the remaining
iterations provably change nothing: a sweep below level 1 certifies no
edge, and a chain step that moved no shard's set is a fixed point.

Exactness caveat (as in the reference): ``max_levels`` / ``max_chain`` must
exceed the graph's diameter / longest recover chain; the defaults suit
small graphs, and large runs size them from the measured diameter.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import trace
from ..kernels import ops
from ..kernels.attach_sharded import AttachInputs, AttachPlan, make_attach_plan
from .distributed import (
    EdgePartition,
    Halo,
    ShardedLabels,
    distributed_build_sharded,
    gathered_position,
)
from .frontier import segment_or
from .graph import INF, Graph, select_landmarks
from .mesh import Mesh, on_device, resolve_mesh
from .packing import take, widen_dist
from .qbs import SPGResult, _reverse_edge_map
from .sketch import compute_sketch_batch


class ShardRecord(NamedTuple):
    """What the vertex-sharded lanes read of an index, made once
    (``shard_record``): the lanes take it in place of per-shard lists."""

    mesh: Mesh
    vstart: np.ndarray        # (S,) int32 first vertex of each shard's block
    n_own: np.ndarray         # (S,) local rows each shard answers for
    v_loc: int                # padded block size
    n_vertices: int
    n_edges: int
    src_sh: list              # per shard (E_max,) int32 global edge sources
    dst_sh: list              # per shard (E_max,) int32 dst - vstart (pad: v_loc)
    landmarks_sh: list        # per shard (R,) int32, replicated
    attach_plan: AttachPlan   # what phase E1's kernels read
    max_levels: int
    max_chain: int


def shard_record(mesh: Mesh, src_sh, dst_sh, vstart: np.ndarray, n_own,
                 v_loc: int, landmarks_sh, *, n_vertices: int, n_edges: int,
                 max_levels: int, max_chain: int) -> ShardRecord:
    """The record of one index's shards, with its attach plan
    (``make_attach_plan``: each shard's in-edge CSR, its closure segments,
    the landmark ids)."""
    plan = make_attach_plan(src_sh, dst_sh, vstart, v_loc, landmarks_sh, n_vertices)
    return ShardRecord(mesh, vstart, np.asarray(n_own), v_loc, n_vertices,
                       n_edges, list(src_sh), list(dst_sh), list(landmarks_sh),
                       plan, max_levels, max_chain)


def _scatter_symmetrize(mesh: Mesh, certs, eid_sh, rev_sh, n_edges: int):
    """Per-shard certified local edges ``(B, E_loc)`` -> the symmetrized
    global mask ``(B, n_edges)`` on ``mesh.devices[0]``: each certified slot
    is set at its global id and at its reverse slot (pad slots target the
    dropped column ``n_edges``).  Setting True is idempotent, so repeated
    slots need no reduction.  Under a profiler: span ``sharded.scatter``."""
    d0 = mesh.devices[0]
    with trace.span("sharded.scatter", mesh.devices):
        acc = torch.zeros((certs[0].shape[0], n_edges + 1), dtype=torch.bool,
                          device=d0)
        for cert, eid, rev in zip(certs, eid_sh, rev_sh):
            rows, cols = torch.nonzero(cert, as_tuple=True)
            trace.count("sharded.host_syncs")
            slots = torch.cat([eid[cols], rev[cols]]).to(d0)
            acc[torch.cat([rows, rows]).to(d0), slots.to(torch.int64)] = True
        return acc[:, :n_edges].contiguous()


def _at_sources(full: torch.Tensor, src: torch.Tensor, vstart: np.ndarray,
                v_loc: int) -> torch.Tensor:
    """All-gathered packed blocks ``(S, v_loc, ...)`` -> the widened int32
    ``(E, ...)`` rows of the global vertex ids ``src`` (a shard's edge
    sources)."""
    sh, off = gathered_position(src, vstart)
    flat = full.reshape(full.shape[0] * v_loc, *full.shape[2:])
    return widen_dist(take(flat, sh * v_loc + off))


def _landmark_ids(ids: torch.Tensor, landmarks: torch.Tensor) -> torch.Tensor:
    """Per id, its landmark index, or -1."""
    eq = ids.to(torch.int64)[:, None] == landmarks.to(torch.int64)[None, :]
    return torch.where(eq.any(dim=1), torch.argmax(eq.to(torch.int32), dim=1), -1)


def general_lane(record: ShardRecord, labels, label_src, meta_w, meta_dist,
                 us: torch.Tensor, vs: torch.Tensor):
    """The general lane on vertex-sharded tables, shared by the sharded
    index and ``core.scale_serve``: phases A (label rows), B (sketch), C
    (bounded Bi-BFS), D (reverse sweeps), E (recover).  See the reference's
    ``core.scale_serve`` for the certificates.

    ``labels`` are the shards' ``(v_loc, R)`` int32 blocks (pad rows INF),
    ``label_src`` the ``(E, R)`` int32 labels of each shard's edge sources;
    ``meta_w`` / ``meta_dist`` ``(R, R)`` int32 and ``us`` / ``vs`` ``(B,)``
    on ``mesh.devices[0]``.  Shard ``s`` answers for its first
    ``record.n_own[s]`` local rows.  Phase E1 is
    ``kernels.ops.sharded_attach`` (the hand-written kernels on the cards,
    reading ``record.attach_plan``).  Returns each shard's ``(B, E)``
    certified local edges and ``dist (B,)`` on ``mesh.devices[0]``.

    Under a profiler each phase is a span over the mesh's devices:
    ``sharded.labels`` (the edge-destination label rows), ``sharded.fetch``
    (A), ``sharded.sketch`` (B), ``sharded.bfs`` (C), ``sharded.sweep``
    (D), ``sharded.attach`` (E1), ``sharded.delta`` (E2) and
    ``sharded.combine`` (the lanes' masks); counters ``sharded.levels``
    (passes of C's loop), ``sharded.host_syncs`` (the host's waits: loop
    tests, ``nonzero``, ``.tolist()``) and, on the cards,
    ``sharded.closure_steps`` (E1's closure steps, all landmarks at once)."""
    mesh = record.mesh
    rep = mesh.replicate
    devs = mesh.devices
    n_shards = mesh.n_shards
    d0 = mesh.devices[0]
    v, vloc, vstart, n_own = record.n_vertices, record.v_loc, record.vstart, record.n_own
    src_sh, dst_sh, max_levels = record.src_sh, record.dst_sh, record.max_levels
    b = us.shape[0]
    r = meta_w.shape[0]
    halo = Halo(mesh, src_sh, vstart, vloc)

    with trace.span("sharded.labels", devs):
        dst_l = [d.to(torch.int64) for d in dst_sh]
        valid_e = [d < vloc for d in dst_l]
        src_lid, dst_lid, gm_e, label_dst = [], [], [], []
        for s in range(n_shards):
            dst_glob = torch.where(valid_e[s], int(vstart[s]) + dst_l[s], v)
            src_lid.append(_landmark_ids(src_sh[s], record.landmarks_sh[s]))
            dst_lid.append(_landmark_ids(dst_glob, record.landmarks_sh[s]))
            gm_e.append((src_lid[s] < 0) & (dst_lid[s] < 0) & valid_e[s])
            pad = torch.full((1, r), INF, dtype=torch.int32, device=dst_glob.device)
            label_dst.append(torch.cat([labels[s], pad])[dst_l[s]])

    def owned(q_sh):
        out = []
        for s, q in enumerate(q_sh):
            loc = q.to(torch.int64) - int(vstart[s])
            out.append(((loc >= 0) & (loc < int(n_own[s])), loc))
        return out

    # ---- A: endpoint label rows from the owning shard ----------------------
    def fetch_rows(q):
        rows = []
        for s, (own, loc) in enumerate(owned(rep(q))):
            row = labels[s][torch.clamp(loc, 0, vloc - 1)]
            rows.append(torch.where(own[:, None], row, INF))
        return mesh.pmin(rows)[0]

    with trace.span("sharded.fetch", devs):
        lu, lv = fetch_rows(us), fetch_rows(vs)

    # ---- B: the sketch, once, replicated ----------------------------------
    with trace.span("sharded.sketch", devs), on_device(d0):
        sk = compute_sketch_batch(lu, lv, meta_w, meta_dist)
    d_top = sk.d_top

    # ---- C: sketch-bounded bidirectional BFS ------------------------------
    def depth0(q):
        out = []
        for s, (own, loc) in enumerate(owned(rep(q))):
            d = torch.full((b, vloc + 1), INF, dtype=torch.int32, device=loc.device)
            d[torch.arange(b, device=loc.device), torch.where(own, loc, vloc)] = \
                torch.where(own, 0, INF).to(torch.int32)
            out.append(d)
        return out

    with trace.span("sharded.bfs", devs):
        depth_u, depth_v = depth0(us), depth0(vs)
        zero = torch.zeros((b,), dtype=torch.int32, device=d0)
        du, dv = zero, zero.clone()
        au = torch.ones((b,), dtype=torch.bool, device=d0)
        av, met = au.clone(), ~au
        cap = torch.clamp(d_top, max=max_levels)

        def reduced_any(xs):
            return mesh.psum([x.any(dim=1).to(torch.int32) for x in xs])[0] > 0

        while True:
            active = (~met) & (du + dv < cap) & (au | av)
            trace.count("sharded.host_syncs")
            if not bool(active.any()):
                break
            trace.count("sharded.levels")
            su = mesh.psum([(x[:, :vloc] < INF).sum(dim=1) for x in depth_u])[0]
            sv = mesh.psum([(x[:, :vloc] < INF).sum(dim=1) for x in depth_v])[0]
            want_u, want_v = sk.d_star_u > du, sk.d_star_v > dv
            pick_u = torch.where(want_u != want_v, want_u, su <= sv)
            pick_u = torch.where(au & av, pick_u, au)
            gu, gv = active & pick_u, active & ~pick_u
            gu_s, gv_s, du_s, dv_s = rep(gu), rep(gv), rep(du), rep(dv)
            fronts = [((depth_u[s][:, :vloc] == du_s[s][:, None]) & gu_s[s][:, None])
                      | ((depth_v[s][:, :vloc] == dv_s[s][:, None]) & gv_s[s][:, None])
                      for s in range(n_shards)]
            bits = halo(fronts)
            new_u, new_v, common = [], [], []
            for s in range(n_shards):
                msg = segment_or(bits[s] & gm_e[s], dst_l[s], vloc + 1)
                nu = msg & (depth_u[s] == INF) & gu_s[s][:, None]
                nv = msg & (depth_v[s] == INF) & gv_s[s][:, None]
                depth_u[s] = torch.where(nu, du_s[s][:, None] + 1, depth_u[s])
                depth_v[s] = torch.where(nv, dv_s[s][:, None] + 1, depth_v[s])
                new_u.append(nu[:, :vloc])
                new_v.append(nv[:, :vloc])
                common.append((depth_u[s][:, :vloc] < INF) & (depth_v[s][:, :vloc] < INF))
            au = torch.where(gu, reduced_any(new_u), au)
            av = torch.where(gv, reduced_any(new_v), av)
            du = torch.where(gu, du + 1, du)
            dv = torch.where(gv, dv + 1, dv)
            met = reduced_any(common)

        commons, sums, mins = [], [], []
        for s in range(n_shards):
            pu, pv = depth_u[s][:, :vloc], depth_v[s][:, :vloc]
            commons.append((pu < INF) & (pv < INF))
            sums.append(torch.where(commons[s], pu + pv, INF))
            mins.append(sums[s].amin(dim=1))
        d_minus = mesh.pmin(mins)[0]
        dist = torch.minimum(d_minus, d_top)
        reverse_on = met & (d_minus <= d_top)
        recover_on = (d_top < INF) & (d_top <= d_minus)
        trivial = us == vs
        dm_s = rep(d_minus)
        w_set = [commons[s] & (sums[s] == dm_s[s][:, None]) for s in range(n_shards)]

    # ---- D: reverse sweeps ------------------------------------------------
    def sweep(depth, d_side):
        on = [torch.cat([w, torch.zeros((b, 1), dtype=torch.bool, device=w.device)],
                        dim=1) for w in w_set]
        emask = [torch.zeros((b, d.shape[0]), dtype=torch.bool, device=d.device)
                 for d in dst_l]
        # past the deepest row's level 1 no row certifies an edge
        trace.count("sharded.host_syncs")
        for i in range(min(int(max_levels), int(d_side.max()))):
            lvl = rep(d_side - i)
            send = [on[s][:, :vloc] & (depth[s][:, :vloc] == lvl[s][:, None])
                    for s in range(n_shards)]
            bits = halo(send)
            for s in range(n_shards):
                cert = bits[s] & gm_e[s] & (depth[s][:, dst_l[s]] == (lvl[s] - 1)[:, None]) \
                    & (lvl[s] > 0)[:, None]
                on[s] = on[s] | segment_or(cert, dst_l[s], vloc + 1)
                emask[s] |= cert
        return emask

    with trace.span("sharded.sweep", devs):
        rev_edges = [a | c for a, c in zip(sweep(depth_u, du), sweep(depth_v, dv))]

    # ---- E1: side attachments, every landmark, both sides as 2B rows -----
    with trace.span("sharded.attach", devs):
        inp = AttachInputs(
            sides=[torch.cat([du_, dv_]) for du_, dv_ in zip(depth_u, depth_v)],
            sigma=rep(torch.cat([sk.du_land, sk.dv_land])), labels=labels,
            label_src=label_src, label_dst=label_dst, dst_l=dst_l,
            src_lid=src_lid, dst_lid=dst_lid, gm_e=gm_e)
        rec_edges = ops.sharded_attach(mesh, halo, record.attach_plan, inp,
                                       record.max_chain)
        del inp

    # ---- E2: Delta edges (fully local) ------------------------------------
    # A pair (i, j) outside a query's sketch enters the reference's min as
    # +INF, so the min can be -1 only through the sketch's own triples: the
    # min runs over those, one edge row per distinct (i, j).
    with trace.span("sharded.delta", devs):
        fin = sk.meta_edge & (meta_w < INF)[None]                # (B, i, j)
        triples = torch.nonzero(fin).tolist()
        w_host = meta_w.tolist()
        trace.count("sharded.host_syncs", 2)
        pairs: dict[tuple[int, int], list[int]] = {}
        for row, i, j in triples:
            pairs.setdefault((i, j), []).append(row)
        g1 = torch.where(fin, meta_w[None] - 1, -1)             # (B, i, j)
        fin_s, g1_s, w_s = rep(fin), rep(g1), rep(meta_w)
        delta = []
        for s in range(n_shards):
            lsrc, ldst = label_src[s], label_dst[s]
            dev = lsrc.device
            minval = torch.full((b, lsrc.shape[0]), 3 * INF, dtype=torch.int32,
                                device=dev)
            for (i, j), rows in pairs.items():
                rows_t = torch.as_tensor(rows, device=dev)
                term = lsrc[:, i] + ldst[:, j] - w_host[i][j]
                minval[rows_t] = torch.minimum(minval[rows_t], term[None, :])
            out = gm_e[s] & (minval == -1)
            # boundary hops r_i -> y (ld[y, j] == w[i, j] - 1) and x -> r_j
            a = torch.nonzero(src_lid[s] >= 0)[:, 0]
            hop1 = (ldst[a][None] == g1_s[s][:, src_lid[s][a], :]).any(dim=2)
            out[:, a] |= hop1
            c = torch.nonzero(dst_lid[s] >= 0)[:, 0]
            hop2 = (lsrc[c][None]
                    == g1_s[s][:, :, dst_lid[s][c]].transpose(1, 2)).any(dim=2)
            out[:, c] |= hop2
            ll = torch.nonzero((src_lid[s] >= 0) & (dst_lid[s] >= 0))[:, 0]
            trace.count("sharded.host_syncs", 3)
            si, di = src_lid[s][ll], dst_lid[s][ll]
            out[:, ll] |= fin_s[s][:, si, di] & (w_s[s][si, di] == 1)[None, :]
            delta.append(out)

    with trace.span("sharded.combine", devs):
        ron, con, keep = rep(reverse_on), rep(recover_on), rep(~trivial)
        masks = []
        for s in range(n_shards):
            m = ((rev_edges[s] & ron[s][:, None])
                 | ((rec_edges[s] | delta[s]) & con[s][:, None]))
            masks.append(m & keep[s][:, None] & valid_e[s][None, :])
    return masks, torch.where(trivial, 0, dist).to(torch.int32)


def landmark_pair_lane(record: ShardRecord, lm_blocks, meta_dist, ru, rv):
    """Landmark-landmark lane from shards: the distance is a replicated
    ``meta_dist`` lookup; the SPG is certified per dst-owned edge from the
    two landmark-distance rows, each chunk gathering exactly its B packed
    rows per side, never the table.  ``lm_blocks`` are the shards' packed
    ``(R, v_loc)`` blocks, ``meta_dist`` the replicated packed ``(R, R)``
    APSP.  Returns each shard's ``(B, E)`` certified local edges and
    ``dist (B,)``; after the scatter-symmetrize, bit-identical to
    ``qbs._landmark_pair_lanes``."""
    mesh, vloc, vstart = record.mesh, record.v_loc, record.vstart
    n = mesh.n_shards
    ru_s = mesh.replicate(ru.to(torch.int64))
    rv_s = mesh.replicate(rv.to(torch.int64))
    full = mesh.all_gather([take(t, i) for t, i in zip(lm_blocks, ru_s)])
    certs = []
    for s in range(n):
        b = ru_s[s].shape[0]
        at_src = _at_sources(full[s].transpose(1, 2), record.src_sh[s], vstart,
                             vloc).T                     # (B, E)
        sel = widen_dist(take(lm_blocks[s], rv_s[s]))
        sel = torch.cat([sel, torch.full((b, 1), INF, dtype=torch.int32,
                                         device=sel.device)], dim=1)
        dst_l = record.dst_sh[s].to(torch.int64)
        d = torch.clamp(widen_dist(take(meta_dist[s], ru_s[s], rv_s[s])),
                        max=INF).to(torch.int32)
        cert = (at_src + 1 + sel[:, dst_l]) == d[:, None]
        certs.append(cert & (d < INF)[:, None] & (dst_l < vloc)[None, :])
        if s == 0:
            dist = d
    return certs, dist


def onesided_lane(record: ShardRecord, lm_blocks, roots, r_idx):
    """One-sided landmark lane from shards: d(root, landmark) reads one
    gathered packed row of ``lm_blocks`` (the shards' packed ``(R, v_loc)``
    blocks); the distance-bounded full-graph BFS from the root runs level
    by level on local edges with the bit-packed halo exchange, state for
    state as ``frontier.bfs_depths_batch``; then each dst-owned edge is
    certified as in ``qbs._landmark_onesided_lanes``.  Returns each shard's
    ``(B, E)`` certified local edges and ``dist (B,)``."""
    mesh, vloc, vstart = record.mesh, record.v_loc, record.vstart
    n = mesh.n_shards
    d0 = mesh.devices[0]
    b = roots.shape[0]
    halo = Halo(mesh, record.src_sh, vstart, vloc)
    full = mesh.all_gather([take(t, i) for t, i in
                            zip(lm_blocks, mesh.replicate(r_idx.to(torch.int64)))])
    roots = roots.to(d0).to(torch.int64)
    root_sh, root_off = gathered_position(roots, vstart)
    flat0 = full[0].permute(1, 0, 2).reshape(b, n * vloc)
    d = widen_dist(take(flat0, torch.arange(b, device=d0),
                               root_sh * vloc + root_off))
    bounds = torch.where(d < INF, d - 1, 0)
    to_lm_src, depth, dst_l = [], [], []
    for s, root in enumerate(mesh.replicate(roots)):
        dev = root.device
        to_lm_src.append(_at_sources(full[s].transpose(1, 2), record.src_sh[s],
                                     vstart, vloc).T)    # (B, E)
        loc = root - int(vstart[s])
        own = (loc >= 0) & (loc < int(record.n_own[s]))
        dep = torch.full((b, vloc + 1), INF, dtype=torch.int32, device=dev)
        dep[torch.arange(b, device=dev), torch.where(own, loc, vloc)] = \
            torch.where(own, 0, INF).to(torch.int32)
        depth.append(dep)
        dst_l.append(record.dst_sh[s].to(torch.int64))

    alive = torch.ones((b,), dtype=torch.bool, device=d0)
    level = 0
    while True:
        act = alive & (level < record.max_levels) & (level < bounds)
        if not bool(act.any()):
            break
        act_s = mesh.replicate(act)
        bits = halo([(x[:, :vloc] == level) & a[:, None]
                     for x, a in zip(depth, act_s)])
        news = []
        for s in range(n):
            new = segment_or(bits[s], dst_l[s], vloc + 1) & (depth[s] == INF)
            depth[s] = torch.where(new, level + 1, depth[s])
            news.append(new[:, :vloc].any(dim=1).to(torch.int32))
        alive = torch.where(act, mesh.psum(news)[0] > 0, alive)
        level += 1

    certs = []
    for s, ds in enumerate(mesh.replicate(d)):
        cert = (to_lm_src[s] + 1 + depth[s][:, dst_l[s]]) == ds[:, None]
        certs.append(cert & (ds < INF)[:, None] & (dst_l[s] < vloc)[None, :])
    return certs, d


class ShardedIndex:
    """``QbSIndex``-shaped serving facade over born-sharded tables.

    The same per-lane steps and query delegates as ``QbSIndex`` (the
    planner and service layers run unchanged on top), but every step
    answers from the vertex-sharded label and CSR blocks: the lanes read
    ``self.record`` (``ShardRecord``), and the index keeps beside it only
    what they are handed per chunk (``self.labels``) and the slot maps
    its scatter-symmetrize reads."""

    is_sharded = True
    epoch = 0   # the sharded tables are build-once: dynamic updates are a
    #             replicated-index feature, so the epoch never advances here

    def __init__(self, graph: Graph, labels: ShardedLabels, part: EdgePartition,
                 mesh: Mesh, *, max_levels: int = 32, max_chain: int = 8,
                 chunk: int = 32):
        # serving reads only the graph's sizes and degrees: they stay on the
        # host, with the partition's blocks and slot maps on the cards
        self.graph = graph.to("cpu")
        self.labels = labels
        self.part = part._replace(eid=None)
        self.mesh = mesh
        self.device = mesh.devices[0]
        self.max_levels = max_levels
        self.max_chain = max_chain
        self.chunk = chunk
        v = graph.n_vertices
        r = labels.n_landmarks

        lm_np = labels.landmarks[0].cpu().numpy()
        self._is_landmark_np = np.zeros((v,), bool)
        self._is_landmark_np[lm_np] = True
        self._lid_np = np.full((v,), -1, np.int32)
        self._lid_np[lm_np] = np.arange(r, dtype=np.int32)
        self._service = None

        # global slot ids and reverse slots, edge-partition-aligned (pads
        # target the dropped column n_edges), made on the graph's device
        gdev = graph.device
        rev = _reverse_edge_map(graph.src, graph.dst, v)
        rev_full = torch.cat([rev, torch.full((1,), graph.n_edges, dtype=torch.int64,
                                              device=gdev)])
        del rev
        src_sh = mesh.shard(part.src)
        dst_sh = mesh.shard(part.dst_local)
        self._eid_sh = [t.to(torch.int64) for t in mesh.shard(part.eid)]
        self._rev_eid_sh = [rev_full[t.to(gdev, torch.int64)].to(d)
                            for t, d in zip(self._eid_sh, mesh.devices)]
        del rev_full
        self.record = shard_record(
            mesh, src_sh, dst_sh, labels.vstart, labels.nloc, part.v_loc,
            labels.landmarks, n_vertices=v, n_edges=graph.n_edges,
            max_levels=max_levels, max_chain=max_chain)

    def _symmetrized(self, certs):
        return _scatter_symmetrize(self.mesh, certs, self._eid_sh,
                                   self._rev_eid_sh, self.record.n_edges)

    # -- per-lane device steps (QbSIndex contract) ---------------------------

    def serve_step(self, us: torch.Tensor, vs: torch.Tensor):
        """General lane: ``(B,)`` pairs -> ``(dist (B,), edge_mask (B, E))``
        on ``self.device``, already symmetrized (the scatter does it).  The
        packed blocks are widened per shard, and each shard's edge-source
        label rows come from a transient all-gather of the packed table (the
        words cross packed and widen at the consumer, never resident).
        Under a profiler each call is one chunk, a ``sharded.serve_step``
        span over the mesh's devices around the lane's spans."""
        lab, rec = self.labels, self.record
        devs = self.mesh.devices
        with trace.span("sharded.serve_step", devs, chunk=True):
            with trace.span("sharded.labels", devs):
                full = self.mesh.all_gather(lab.labels_sh)       # (S, v_loc, R)
                label_src = [_at_sources(x, src, rec.vstart, rec.v_loc)
                             for x, src in zip(full, rec.src_sh)]
                del full
            d0 = self.device
            certs, dist = general_lane(
                rec, [widen_dist(t) for t in lab.labels_sh], label_src,
                widen_dist(lab.meta_w[0]).to(d0), widen_dist(lab.meta_dist[0]).to(d0),
                us.to(d0), vs.to(d0))
            mask = self._symmetrized(certs)
        return dist, mask

    def landmark_pair_step(self, ru: torch.Tensor, rv: torch.Tensor):
        certs, dist = landmark_pair_lane(self.record, self.labels.lm_sh,
                                         self.labels.meta_dist, ru, rv)
        return dist, self._symmetrized(certs)

    def landmark_onesided_step(self, roots: torch.Tensor, r_idx: torch.Tensor):
        certs, dist = onesided_lane(self.record, self.labels.lm_sh, roots, r_idx)
        return dist, self._symmetrized(certs)

    # -- memory accounting ---------------------------------------------------

    def sharded_size_bytes(self) -> dict:
        """Per-device resident bytes against the replicated layout the index
        replaces."""
        item = self.labels.pack_dtype.itemsize
        v, r = self.labels.n_vertices, self.labels.n_landmarks
        e = self.graph.n_edges
        per_device_label = self.labels.per_device_label_bytes()
        # src + dst_local + eid + rev_eid, one edge shard each
        per_device_csr = 4 * self.part.e_max * 4
        replicated_label = (2 * v * r + 2 * r * r) * item
        replicated_csr = 3 * e * 4          # src + dst + rev_edge
        per_device = per_device_label + per_device_csr
        replicated = replicated_label + replicated_csr
        return {
            "n_shards": self.mesh.n_shards,
            "per_device_label_bytes": per_device_label,
            "per_device_csr_bytes": per_device_csr,
            "per_device_bytes": per_device,
            "replicated_label_bytes": replicated_label,
            "replicated_csr_bytes": replicated_csr,
            "replicated_bytes": replicated,
            "per_device_frac": per_device / max(replicated, 1),
        }

    # -- construction --------------------------------------------------------

    @classmethod
    def build(cls, graph: Graph, n_landmarks: int = 20,
              landmarks: np.ndarray | None = None, mesh: Mesh | int | None = None,
              frontier_mode: str = "bitmap", build_max_levels: int = 64,
              **kw) -> "ShardedIndex":
        """Build the labels distributed (born sharded) and wrap them for
        serving.  ``mesh`` is a ``core.mesh.Mesh``, a device count (the
        first N CUDA devices) or ``None`` (every CUDA device); without a
        CUDA device only an explicit ``Mesh`` of CPU devices runs."""
        mesh = resolve_mesh(mesh)
        if landmarks is None:
            landmarks = select_landmarks(graph, n_landmarks)
        labels, part = distributed_build_sharded(
            graph, np.asarray(landmarks), mesh, frontier_mode=frontier_mode,
            max_levels=build_max_levels)
        return cls(graph, labels, part, mesh, **kw)

    # -- queries (thin delegates over the planner/service) -------------------

    def make_service(self, **kw):
        from ..serving.service import ServingService
        return ServingService(self, **kw)

    def make_stream(self, *, policy=None, **kw):
        from ..serving.stream import StreamingService
        return StreamingService(self, policy=policy, **kw)

    def _default_service(self):
        if self._service is None:
            self._service = self.make_service()
        return self._service

    def query_batch(self, us, vs) -> list[SPGResult]:
        return self._default_service().query_batch(us, vs)

    def query_batch_arrays(self, us, vs):
        return self._default_service().query_arrays(us, vs)

    def query(self, u: int, v: int) -> SPGResult:
        return self.query_batch([u], [v])[0]
