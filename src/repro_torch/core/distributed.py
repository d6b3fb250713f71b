"""Distributed QbS: the edge partition, the edge-sharded labelling and the
born-sharded packed tables over a ``core.mesh.Mesh``.  Counterpart of
``repro.core.distributed``.

* **Labelling** (offline): the R landmark BFSs are one batched frontier
  program.  Edges are sharded by destination-vertex block (blocks cut at
  balanced edge counts, so hub-heavy blocks stay narrow); ``depth`` and
  ``reach_L`` live vertex-sharded next to the edges that write them.  Each
  level every shard relays its local edges with ``frontier.segment_or`` and
  the new frontier is exchanged:

    - ``frontier_mode="bool"``   : all-gather the (2, R, V_loc) bool flags;
    - ``frontier_mode="bitmap"`` : all-gather them bit-packed (``pack_bits``
      words, 32 vertices per int32 word holding the uint32 bit pattern);
    - ``frontier_mode="pull"``   : one all-to-all of packed bit buffers
      holding only the vertices each shard's edges read (``PullPlan``).

  Order-independence (Lemma 5.2) makes the shard-local relays commute, so
  the merge is an exact OR/min and the result equals ``build_labelling``.
* **Born-sharded tables** (``distributed_build_sharded``): the labelling
  finishes on the shards, so the packed label and landmark-distance tables
  are born one vertex block per device (``ShardedLabels``); only the
  (R, R) landmark block crosses to the host, for ``meta_apsp`` and the
  pack-dtype ladder.  ``core.sharded.ShardedIndex`` serves from them.

A shard's state is a list entry, one per device of the mesh; the loop over
shards is the ``shard_map`` body and every exchange is a ``Mesh``
collective.  Every loop's stop test reads a value reduced over all shards,
so every shard runs the same number of levels.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import trace
from .frontier import segment_or
from .graph import INF, Graph
from .labelling import LabellingScheme, meta_apsp
from .mesh import Mesh
from .packing import _np_dtype, choose_pack_dtype, pack_bits, pack_dist, sentinel_of


class EdgePartition(NamedTuple):
    """Edge partition into S destination-contiguous shards, as
    ``partition_graph`` makes it: ``src``, ``dst_local`` and ``eid`` hold
    one ``(E_max,)`` int32 tensor per shard on its mesh device; ``host()``
    gives them as ``(S, E_max)`` arrays."""

    src: list               # (E_max,) int32 per shard, global src ids (pad: 0)
    dst_local: list         # (E_max,) int32 per shard, dst - vstart (pad: V_loc_max)
    vstart: np.ndarray      # (S,) int32 first vertex of each shard's block
    v_loc: int              # max local block size (padded)
    e_max: int
    eid: list | None = None  # (E_max,) int32 per shard, global edge-slot ids
    #                          (pad: n_edges): sharded serving scatters local
    #                          certificates back into the canonical (B, E)
    #                          edge mask

    def host(self) -> "EdgePartition":
        """The partition with its blocks as host ``(S, E_max)`` arrays."""
        def np_of(x):
            if x is None or isinstance(x, np.ndarray):
                return x
            return np.stack([t.cpu().numpy() for t in x])
        return self._replace(src=np_of(self.src), dst_local=np_of(self.dst_local),
                             eid=np_of(self.eid))


def partition_graph(graph: Graph, mesh: Mesh) -> EdgePartition:
    """Cut vertices into contiguous blocks with ~equal *edge* counts (not
    vertex counts) so degree skew does not make straggler shards, one block
    per device of ``mesh``, then assign each directed edge to its
    destination's block.  The stable sort by destination, the edge-quantile
    cuts and the block searches run on the graph's device, and shard
    ``s``'s padded ``(E_max,)`` blocks are cut from the sorted edges and
    placed on ``mesh.devices[s]``.  The edge slots never cross to the host;
    the cuts (S + 1 small values) do.  Every array equals the reference's
    ``partition_edges``."""
    n_shards = mesh.n_shards
    v, e = graph.n_vertices, graph.n_edges
    dev = graph.device
    dsorted, order = torch.sort(graph.dst, stable=True)
    targets = torch.as_tensor([min((e * s) // n_shards, e - 1)
                               for s in range(1, n_shards)], dtype=torch.int64)
    cuts = [0] + dsorted[targets.to(dev)].tolist() + [v]
    vstart = np.maximum.accumulate(np.asarray(cuts[:-1], np.int64))
    vend = np.concatenate([vstart[1:], [v]])
    v_loc = int((vend - vstart).max())

    def search(x, right=False):
        q = torch.as_tensor(x.astype(np.int32), device=dev)
        return torch.searchsorted(dsorted, q, right=right).cpu().numpy()

    starts = search(vstart)
    ends = np.maximum(search(vend - 1, right=True), starts)     # guard empty blocks
    e_max = max(int((ends - starts).max()), 1)
    src_sh, dst_sh, eid_sh = [], [], []
    for s, d in enumerate(mesh.devices):
        a, b = int(starts[s]), int(ends[s])
        src = torch.zeros((e_max,), dtype=torch.int32, device=dev)
        dst = torch.full((e_max,), v_loc, dtype=torch.int32, device=dev)
        eid = torch.full((e_max,), e, dtype=torch.int32, device=dev)
        src[:b - a] = graph.src[order[a:b]]
        dst[:b - a] = dsorted[a:b] - int(vstart[s])
        eid[:b - a] = order[a:b].to(torch.int32)
        src_sh.append(src.to(d))
        dst_sh.append(dst.to(d))
        eid_sh.append(eid.to(d))
    return EdgePartition(src_sh, dst_sh, vstart.astype(np.int32), v_loc,
                         e_max, eid_sh)


def gathered_position(ids: torch.Tensor, vstart: np.ndarray):
    """Global vertex ids -> ``(owning shard, offset in its block)``, int64,
    on the ids' device."""
    starts = torch.as_tensor(vstart, dtype=torch.int64, device=ids.device)
    ids = ids.to(torch.int64)
    shard = torch.clamp(torch.searchsorted(starts, ids, right=True) - 1,
                        0, len(vstart) - 1)
    return shard, ids - starts[shard]


def read_bits(words: torch.Tensor, word_idx: torch.Tensor,
              bit: torch.Tensor) -> torch.Tensor:
    """Bit ``bit[e]`` of word ``word_idx[e]`` of every row: ``(..., W)``
    int32 words -> ``(..., E)`` bool."""
    return ((words[..., word_idx] >> bit) & 1) > 0


class Halo:
    """The bit-packed frontier exchange over one edge set: each shard packs
    its ``(rows, v_loc)`` bool block into words, the words are all-gathered,
    and each shard reads the bits of its edges' global sources ``src_sh``
    straight from them (the bool frontier is never gathered).  ``words``
    all-gathers tables that are words already (the sharded attach's).  Under a
    profiler each call is a ``sharded.halo`` span over the mesh's devices
    and adds the bytes the all-gather moves between shards, ``S (S - 1)``
    blocks of ``rows * wloc`` int32 words, to ``sharded.halo_bytes``."""

    def __init__(self, mesh: Mesh, src_sh, vstart: np.ndarray, v_loc: int):
        self.mesh = mesh
        self.wloc = (v_loc + 31) // 32
        self.word, self.bit = [], []
        for src in src_sh:
            shard, off = gathered_position(src, vstart)
            self.word.append(shard * self.wloc + off // 32)
            self.bit.append((off % 32).to(torch.int32))

    def __call__(self, masks, edges=None):
        """Per-shard ``(rows, v_loc)`` bool -> per-shard ``(rows, E)`` bool
        source bits, or ``(rows, len(edges[s]))`` on an edge subset."""
        n = self.mesh.n_shards
        with trace.span("sharded.halo", self.mesh.devices):
            trace.count("sharded.halo_bytes",
                        n * (n - 1) * masks[0].shape[0] * self.wloc * 4)
            full = self.mesh.all_gather([pack_bits(m) for m in masks])
            out = []
            for s, x in enumerate(full):
                flat = x.permute(1, 0, 2).reshape(x.shape[1], n * self.wloc)
                word, bit = self.word[s], self.bit[s]
                if edges is not None:
                    word, bit = word[edges[s]], bit[edges[s]]
                out.append(read_bits(flat, word, bit))
            return out

    def words(self, *blocks):
        """Per-shard int32 word tables, each list's tensors of one shape ->
        for each list, every shard's ``(S, ...)`` stack of all shards' tables:
        raw words all-gathered, with no ``pack_bits`` and no bit reads.  One
        ``sharded.halo`` span, adding ``S (S - 1)`` times each table's bytes
        to ``sharded.halo_bytes``."""
        n = self.mesh.n_shards
        with trace.span("sharded.halo", self.mesh.devices):
            trace.count("sharded.halo_bytes", n * (n - 1) * sum(
                x[0].numel() * x[0].element_size() for x in blocks))
            return tuple(self.mesh.all_gather(x) for x in blocks)


# ---------------------------------------------------------------------------
# Edge-sharded labelling
# ---------------------------------------------------------------------------


class PullPlan(NamedTuple):
    """Static routing plan for the demand-driven frontier exchange.

    A shard only ever reads the frontier bits of *its local edges'
    sources*; the plan lists, per (sender i, receiver j), the sorted
    i-owned vertices that j needs, so the exchange is one all_to_all of
    packed bit buffers and per-edge reads are static word/bit lookups."""

    send_idx: np.ndarray   # (S, S, P) int32: [i][j] = local idx of vertices i sends j
    edge_word: np.ndarray  # (S, E_max) int32: per-edge word into flat recv buffer
    edge_bit: np.ndarray   # (S, E_max) int32: per-edge bit position
    p_pad: int             # padded per-pair list length (multiple of 32)


def build_pull_plan(part: EdgePartition, n_shards: int) -> PullPlan:
    vstart = part.vstart.astype(np.int64)
    s_cnt = n_shards
    lists: list[list[np.ndarray]] = [[None] * s_cnt for _ in range(s_cnt)]  # type: ignore
    p_max = 1
    for j in range(s_cnt):
        valid = part.dst_local[j] < part.v_loc
        srcs = np.unique(part.src[j][valid])
        owner = np.clip(np.searchsorted(vstart, srcs, side="right") - 1, 0, s_cnt - 1)
        for i in range(s_cnt):
            li = srcs[owner == i]
            lists[i][j] = li
            p_max = max(p_max, li.size)
    p_pad = ((p_max + 31) // 32) * 32
    pw = p_pad // 32

    send_idx = np.zeros((s_cnt, s_cnt, p_pad), np.int32)
    for i in range(s_cnt):
        for j in range(s_cnt):
            li = lists[i][j]
            send_idx[i, j, : li.size] = (li - vstart[i]).astype(np.int32)

    edge_word = np.zeros((s_cnt, part.e_max), np.int32)
    edge_bit = np.zeros((s_cnt, part.e_max), np.int32)
    for j in range(s_cnt):
        valid = part.dst_local[j] < part.v_loc
        srcs = part.src[j]
        owner = np.clip(np.searchsorted(vstart, srcs, side="right") - 1, 0, s_cnt - 1)
        pos = np.zeros(srcs.shape, np.int64)
        for i in range(s_cnt):
            sel = (owner == i) & valid
            pos[sel] = np.searchsorted(lists[i][j], srcs[sel])
        edge_word[j] = (owner * pw + pos // 32).astype(np.int32)
        edge_bit[j] = (pos % 32).astype(np.int32)
    return PullPlan(send_idx, edge_word, edge_bit, p_pad)


def _labelling_init(landmarks: torch.Tensor, vst: int, vloc: int, v: int):
    """A shard's starting state: ``depth`` (R, vloc + 1) and ``reach``
    (R, vloc + 1) with column ``vloc`` the garbage slot for unowned writes,
    and ``prop_ok`` (R, vloc), the vertices allowed as path interior."""
    r = landmarks.shape[0]
    dev = landmarks.device
    rows = torch.arange(r, device=dev)
    lm = landmarks.to(torch.int64)
    lm_local = lm - vst
    own = (lm >= vst) & (lm_local < vloc)
    lm_idx = torch.where(own, lm_local, vloc)
    depth = torch.full((r, vloc + 1), INF, dtype=torch.int32, device=dev)
    depth[rows, lm_idx] = 0
    reach = torch.zeros((r, vloc + 1), dtype=torch.bool, device=dev)
    reach[rows, lm_idx] = own
    # landmark-ness on the fly: (R, vloc) root mask and its any-reduction
    local_ids = torch.clamp(vst + torch.arange(vloc, device=dev), 0, v - 1)
    is_root_loc = local_ids[None, :] == lm[:, None]
    prop_ok = (~is_root_loc.any(dim=0))[None, :] | is_root_loc
    return depth, reach, prop_ok


def _labelling_loop(mesh: Mesh, exchange: Callable, dst_sh, states,
                    vloc: int, max_levels: int):
    """The level loop shared by every frontier mode: per shard, frontier and
    L-frontier -> ``exchange`` -> one fused local relay of both."""
    level = 0
    alive = True
    r = states[0][0].shape[0]
    while alive and level < max_levels:
        fronts = []
        for depth, reach, prop_ok in states:
            fr = depth[:, :vloc] == level
            fronts.append((fr, fr & reach[:, :vloc] & prop_ok))
        read = exchange(fronts)                   # per shard (2R, E) bool
        flags = []
        for s, (depth, reach, prop_ok) in enumerate(states):
            msg = segment_or(read[s], dst_sh[s], vloc + 1)
            new = msg[:r] & (depth == INF)
            depth = torch.where(new, level + 1, depth)
            reach = reach | (new & msg[r:])
            states[s] = (depth, reach, prop_ok)
            flags.append(new[:, :vloc].any().to(torch.int32))
        # the flag is reduced over all shards: each runs the same levels
        alive = bool(mesh.psum(flags)[0] > 0)
        level += 1
    return ([d[:, :vloc] for d, _, _ in states],
            [rc[:, :vloc] for _, rc, _ in states])


def make_labelling_step(mesh: Mesh, *, n_vertices: int, v_loc: int,
                        n_landmarks: int, frontier_mode: str = "bitmap",
                        max_levels: int = 64):
    """The edge-sharded labelling program (push exchange, ``"bool"`` or
    ``"bitmap"``).

    ``step(src_sh, dst_sh, vstart, landmarks_sh)``: per-shard ``(E_max,)``
    int32 global sources and local destinations, the host ``(S,)`` block
    starts, the replicated ``(R,)`` landmarks -> per-shard ``depth``
    (R, v_loc) int32 and ``reach_L`` (R, v_loc) bool."""
    if frontier_mode not in ("bool", "bitmap"):
        raise ValueError(f"unknown frontier_mode {frontier_mode!r}")
    v, vloc = n_vertices, v_loc
    n_shards = mesh.n_shards

    def step(src_sh, dst_sh, vstart, landmarks_sh):
        states = [_labelling_init(lm, int(vstart[s]), vloc, v)
                  for s, lm in enumerate(landmarks_sh)]
        r = n_landmarks
        if frontier_mode == "bitmap":
            halo = Halo(mesh, src_sh, vstart, vloc)

            def exchange(fronts):
                return halo([torch.cat(f) for f in fronts])          # (2R, V_loc)
        else:
            src_g = []
            for src in src_sh:
                sh, off = gathered_position(src, vstart)
                src_g.append(sh * vloc + off)

            def exchange(fronts):
                full = mesh.all_gather([torch.stack(f) for f in fronts])
                return [x.permute(1, 2, 0, 3).reshape(
                            2 * r, n_shards * vloc)[:, src_g[s]]
                        for s, x in enumerate(full)]

        return _labelling_loop(mesh, exchange, dst_sh, states, vloc, max_levels)

    return step


def make_labelling_step_pull(mesh: Mesh, *, n_vertices: int, v_loc: int,
                             p_pad: int, n_landmarks: int, max_levels: int = 64):
    """The labelling program with the demand-driven (pull) exchange:
    ``step(src_sh, dst_sh, vstart, landmarks_sh, send_idx_sh, edge_word_sh,
    edge_bit_sh)`` with the ``PullPlan``'s blocks per shard."""
    v, vloc, r = n_vertices, v_loc, n_landmarks
    pw = p_pad // 32
    n_shards = mesh.n_shards

    def step(src_sh, dst_sh, vstart, landmarks_sh, send_idx_sh, edge_word_sh,
             edge_bit_sh):
        states = [_labelling_init(lm, int(vstart[s]), vloc, v)
                  for s, lm in enumerate(landmarks_sh)]
        send = [i.to(torch.int64) for i in send_idx_sh]
        word = [w.to(torch.int64) for w in edge_word_sh]

        def exchange(fronts):
            bufs = []
            for s, (fr, pl) in enumerate(fronts):
                vals = torch.cat([fr, pl])[:, send[s]]           # (2R, S, P)
                bufs.append(pack_bits(vals).permute(1, 0, 2))  # (S, 2R, Pw)
            recv = mesh.all_to_all(bufs)
            return [read_bits(x.permute(1, 0, 2).reshape(2 * r, n_shards * pw),
                              word[s], edge_bit_sh[s])
                    for s, x in enumerate(recv)]

        return _labelling_loop(mesh, exchange, dst_sh, states, vloc, max_levels)

    return step


def _run_labelling(graph: Graph, landmarks: np.ndarray, mesh: Mesh,
                   part: EdgePartition, frontier_mode: str, max_levels: int):
    """The edge-sharded labelling on ``part``: per-shard depth and reach_L."""
    v = graph.n_vertices
    r = int(landmarks.shape[0])
    src_sh = mesh.shard(part.src)
    dst_sh = mesh.shard(part.dst_local)
    lm_sh = mesh.replicate(torch.as_tensor(landmarks.astype(np.int32)))
    if frontier_mode == "pull":
        plan = build_pull_plan(part.host(), mesh.n_shards)
        step = make_labelling_step_pull(
            mesh, n_vertices=v, v_loc=part.v_loc, p_pad=plan.p_pad,
            n_landmarks=r, max_levels=max_levels)
        return step(src_sh, dst_sh, part.vstart, lm_sh,
                    mesh.shard(plan.send_idx), mesh.shard(plan.edge_word),
                    mesh.shard(plan.edge_bit))
    step = make_labelling_step(
        mesh, n_vertices=v, v_loc=part.v_loc, n_landmarks=r,
        frontier_mode=frontier_mode, max_levels=max_levels)
    return step(src_sh, dst_sh, part.vstart, lm_sh)


def distributed_build_labelling(  # qbslint: host-boundary
        graph: Graph, landmarks, mesh: Mesh, *, frontier_mode: str = "bitmap",
        max_levels: int = 64) -> LabellingScheme:
    """Edge-sharded Algorithm 2 over a device mesh, equal to the
    single-device ``build_labelling`` for any shard count, reassembled on the
    host into the dense scheme on ``mesh.devices[0]``.  ``frontier_mode``:
    ``"bool"``, ``"bitmap"`` or ``"pull"``."""
    landmarks = np.array(landmarks, np.int32)
    part = partition_graph(graph, mesh)
    depth_sh, reach_sh = _run_labelling(graph, landmarks, mesh, part,
                                        frontier_mode, max_levels)
    v = graph.n_vertices
    r = landmarks.shape[0]
    # host re-assembly into the canonical dense labelling
    depth_full = np.full((r, v), INF, np.int64)
    reach_full = np.zeros((r, v), bool)
    vend = np.concatenate([part.vstart[1:], [v]])
    for s in range(mesh.n_shards):
        a, b = part.vstart[s], vend[s]
        depth_full[:, a:b] = depth_sh[s][:, :b - a].cpu().numpy()
        reach_full[:, a:b] = reach_sh[s][:, :b - a].cpu().numpy()

    is_lm = np.zeros((v,), bool)
    is_lm[landmarks] = True
    valid = reach_full & ~is_lm[None, :]
    label_dist = np.where(valid, depth_full, INF).T.astype(np.int32)
    meta_w = np.where(reach_full[:, landmarks], depth_full[:, landmarks], INF)
    np.fill_diagonal(meta_w, INF)
    meta_w = np.minimum(meta_w, meta_w.T).astype(np.int32)
    lid = np.full((v,), -1, np.int32)
    lid[landmarks] = np.arange(r, dtype=np.int32)

    dev = mesh.devices[0]
    meta_w_t = torch.as_tensor(meta_w, device=dev)
    return LabellingScheme(
        landmarks=torch.as_tensor(landmarks, device=dev),
        lid=torch.as_tensor(lid, device=dev),
        is_landmark=torch.as_tensor(is_lm, device=dev),
        label_dist=torch.as_tensor(np.ascontiguousarray(label_dist), device=dev),
        meta_w=meta_w_t,
        meta_dist=meta_apsp(meta_w_t))


# ---------------------------------------------------------------------------
# Born-sharded labelling: packed tables that never leave the mesh
# ---------------------------------------------------------------------------


class ShardedLabels(NamedTuple):
    """Packed label tables of one index, vertex-sharded over a mesh: one
    contiguous vertex block per device.  The (R, R) meta tables and the
    landmark list are replicated, one copy per shard (the sketch's
    landmark-landmark block, tiny by design).  The host fields hold the
    partition's geometry only: the full (V, R) table exists nowhere."""

    labels_sh: list          # per shard (v_loc, R) packed
    lm_sh: list              # per shard (R, v_loc) packed
    meta_w: list             # per shard (R, R) packed, replicated
    meta_dist: list          # per shard (R, R) packed, replicated (APSP)
    landmarks: list          # per shard (R,) int32, replicated
    vstart: np.ndarray       # (S,) int32 first vertex of each block
    nloc: np.ndarray         # (S,) int32 real (un-padded) block sizes
    v_loc: int               # padded block size
    n_vertices: int

    @property
    def n_landmarks(self) -> int:
        return int(self.labels_sh[0].shape[-1])

    @property
    def pack_dtype(self) -> np.dtype:
        return _np_dtype(self.labels_sh[0].dtype)

    @property
    def sentinel(self) -> int:
        return sentinel_of(self.labels_sh[0].dtype)

    def per_device_label_bytes(self) -> int:
        """Packed label bytes resident on one device: its (v_loc, R) label
        block, its (R, v_loc) landmark-distance block and the replicated
        meta pair."""
        item = self.pack_dtype.itemsize
        r = self.n_landmarks
        return 2 * self.v_loc * r * item + 2 * r * r * item


def make_sharded_finalize(mesh: Mesh, *, v_loc: int):
    """Device program A of the born-sharded build: per shard, the raw state
    (depth, reach_L) -> the int32 label block ``where(reach & ~is_lm & real,
    depth, INF).T`` (pad rows INF), plus the replicated (R, R) ``at_land`` /
    ``l_at_land`` readouts, each landmark read from its exact owner
    (owned-else-neutral, then ``pmin`` / ``pmax``)."""
    vloc = v_loc

    def body(depth_sh, reach_sh, vstart, nloc, landmarks_sh):
        labels, at, lat = [], [], []
        for s, (depth, reach, lm) in enumerate(zip(depth_sh, reach_sh, landmarks_sh)):
            vst, n_loc = int(vstart[s]), int(nloc[s])
            dev = depth.device
            lm = lm.to(torch.int64)
            pos = torch.arange(vloc, device=dev)
            is_lm_loc = ((vst + pos)[:, None] == lm[None, :]).any(dim=1)
            valid = reach & (~is_lm_loc & (pos < n_loc))[None, :]
            labels.append(torch.where(valid, depth, INF).T.contiguous())
            own = (lm >= vst) & (lm < vst + n_loc)
            idx = torch.clamp(lm - vst, 0, vloc - 1)
            at.append(torch.where(own[None, :], depth[:, idx], INF))
            lat.append(torch.where(own[None, :], reach[:, idx], False)
                       .to(torch.int32))
        l_at = [x > 0 for x in mesh.pmax(lat)]
        return labels, mesh.pmin(at), l_at

    return body


def make_sharded_lm_table(mesh: Mesh, *, v_loc: int, n_landmarks: int):
    """Device program B: per shard, the (R, v_loc) exact vertex-to-landmark
    distances from the int32 label block and the replicated meta APSP (the
    vertex-sharded twin of ``qbs._dists_to_landmark_batch``; pad rows INF),
    and the largest finite entry over label and lm tables, reduced with
    ``pmax``, for the pack-dtype ladder."""
    vloc, r = v_loc, n_landmarks

    def body(label_sh, vstart, nloc, landmarks_sh, meta_dist_sh):
        lms, mxs = [], []
        for s, (lab, lm, md) in enumerate(zip(label_sh, landmarks_sh, meta_dist_sh)):
            vst, n_loc = int(vstart[s]), int(nloc[s])
            dev = lab.device
            # base[x, c] = min_i lab[x, i] + meta_dist[i, c] (non-landmark rows)
            base = lab[:, 0][:, None] + md[0][None, :]
            for i in range(1, r):
                base = torch.minimum(base, lab[:, i][:, None] + md[i][None, :])
            pos = torch.arange(vloc, device=dev)
            eqs = (vst + pos)[:, None] == lm.to(torch.int64)[None, :]
            is_lm = eqs.any(dim=1)
            at_lm = md[torch.argmax(eqs.to(torch.int32), dim=1)]  # row 0 where not
            out = torch.clamp(torch.where(is_lm[:, None], at_lm, base), max=INF)
            out = torch.where((pos < n_loc)[:, None], out, INF).to(torch.int32)
            mx = torch.maximum(torch.where(lab < INF, lab, -1).max(),
                               torch.where(out < INF, out, -1).max())
            lms.append(out.T.contiguous())
            mxs.append(mx)
        return lms, mesh.pmax(mxs)

    return body


def distributed_build_sharded(  # qbslint: host-boundary
        graph: Graph, landmarks, mesh: Mesh, *, frontier_mode: str = "bitmap",
        max_levels: int = 64) -> tuple[ShardedLabels, EdgePartition]:
    """Edge-sharded Algorithm 2 whose packed tables are *born*
    vertex-sharded: the labelling finishes on the shards and only the
    (R, R) landmark block crosses to the host, to run ``meta_apsp`` and the
    pack-dtype ladder.  Packs the same values, block for block, that
    ``distributed_build_labelling`` then ``pack_labelling`` would, in the
    same dtype, with the sentinel in the pad rows.  Returns
    ``(ShardedLabels, EdgePartition)``; the partition is also the serving
    CSR layout of ``core.sharded.ShardedIndex``."""
    landmarks = np.array(landmarks, np.int32)
    part = partition_graph(graph, mesh)
    v = graph.n_vertices
    r = landmarks.shape[0]
    vend = np.concatenate([part.vstart[1:], [v]])
    nloc = (vend - part.vstart).astype(np.int32)
    depth_sh, reach_sh = _run_labelling(graph, landmarks, mesh, part,
                                        frontier_mode, max_levels)
    lm_sh = mesh.replicate(torch.as_tensor(landmarks))

    finalize = make_sharded_finalize(mesh, v_loc=part.v_loc)
    label32_sh, at_land, l_at_land = finalize(depth_sh, reach_sh, part.vstart,
                                              nloc, lm_sh)
    # host boundary: the (R, R) landmark block, R^2 ints
    at_np = at_land[0].cpu().numpy()
    meta_w_np = np.where(l_at_land[0].cpu().numpy(), at_np, INF)
    np.fill_diagonal(meta_w_np, INF)
    meta_w_np = np.minimum(meta_w_np, meta_w_np.T).astype(np.int32)
    md_np = meta_apsp(torch.as_tensor(meta_w_np)).numpy()

    lm_step = make_sharded_lm_table(mesh, v_loc=part.v_loc, n_landmarks=r)
    lm32_sh, mx = lm_step(label32_sh, part.vstart, nloc, lm_sh,
                          mesh.replicate(torch.as_tensor(md_np)))
    # the dtype ladder of choose_pack_dtype, fed the pmax scalar instead of
    # a gathered table
    dtype = choose_pack_dtype(np.asarray([max(int(mx[0]), 0)]), meta_w_np, md_np)
    return ShardedLabels(
        labels_sh=[pack_dist(t, dtype) for t in label32_sh],
        lm_sh=[pack_dist(t, dtype) for t in lm32_sh],
        meta_w=mesh.replicate(pack_dist(meta_w_np, dtype)),
        meta_dist=mesh.replicate(pack_dist(md_np, dtype)),
        landmarks=lm_sh,
        vstart=part.vstart,
        nloc=nloc,
        v_loc=part.v_loc,
        n_vertices=v,
    ), part

