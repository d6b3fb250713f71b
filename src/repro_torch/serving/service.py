"""SPG serving service: lane execution over a ``QueryPlan``.
Counterpart of ``repro.serving.service`` on one device.

The planner owns *what* runs (``serving.planner``); the service owns *how*:

* **Chunked dispatch.**  Every lane chunk is a device step returning device
  tensors, and the service keeps up to ``async_depth`` chunks in flight (a
  deque), copying the oldest to the host only when the window is full.
  ``async_depth=1`` is the strictly synchronous dispatch-then-copy loop.
  The copy is ``edge_ids_of``: the SPG edges leave the device as
  ``(row, slot)`` pairs of the chunk's ``(L, E)`` mask (``torch.nonzero``
  on the card), a few KB instead of the mask; the streaming scheduler
  drains its chunks through the same helper.
* **Result cache.**  An optional ``ResultCache`` keyed on the canonical
  pair plus the serving epoch ``(min(u, v), max(u, v), epoch)``, holding
  packed ``(dist, edge_ids)`` values: lookups at plan time (hit rows leave
  their lanes before chunking), inserts as chunks drain, through
  ``cache_put`` and its admission policy.  ``cache_policy="hub"`` protects
  entries whose endpoint is a landmark or a top-degree hub;
  ``cache_admission="reuse"`` admits a cold pair only on its second
  sighting.  The cache is host-side, as in the reference.
* **Epochs.**  ``install_index`` swaps in the next epoch's index (an
  ``apply_update`` product); the cache keys carry the epoch, so an entry of
  an earlier epoch is never served.
* **Several cards.**  The service runs each lane on the index's own steps:
  a ``ShardedIndex`` (``core.sharded``) answers every lane vertex-sharded
  over its mesh, and the service sees one index either way.
"""
from __future__ import annotations

from collections import OrderedDict, deque
from functools import partial
from typing import Callable, Iterator

import numpy as np
import torch

from .. import trace
from ..core.graph import INF
from .planner import (
    LANE_GENERAL,
    LANE_LANDMARK_PAIR,
    LANE_ONE_SIDED,
    LANE_TRIVIAL,
    N_LANES,
    QueryPlan,
    chunk_padded,
    d_top_of,
    onesided_roots,
    plan_queries,
)

_NO_EDGES = np.zeros((0,), np.int32)   # edge counts fit int32 (E << 2^31)
_NO_EDGES.flags.writeable = False   # shared by every trivial-lane result


def edge_ids_of(dist: torch.Tensor, mask: torch.Tensor,
                live: int) -> tuple[np.ndarray, list[np.ndarray]]:
    """One drained chunk to the host: ``(dist (live,) int32, [live sorted
    int32 edge-id arrays])``.  The edges leave the device as row-major
    ``(row, slot)`` pairs from ``torch.nonzero`` on the mask, so per row
    they come out ascending, exactly as ``np.flatnonzero`` of the mask row
    would give them."""
    with trace.span("drain", mask):
        nz = torch.nonzero(mask[:live]).cpu().numpy()
        d = dist[:live].cpu().numpy()
        cuts = np.searchsorted(nz[:, 0], np.arange(1, live))
        return d, np.split(nz[:, 1].astype(np.int32), cuts)


def _pack_result(value: tuple[int, np.ndarray]) -> tuple:
    """Pack a ``(dist, edge_ids)`` result for cache residency: int32 edge
    ids, delta-encoded as uint16 gaps when the sorted id list allows it
    (the anchor id stays int32).  Returns ``(nbytes, dist, enc)``;
    ``nbytes`` feeds the byte-based capacity accounting."""
    dist, eids = value
    eids = np.asarray(eids)
    if eids.dtype != np.int32:
        eids = eids.astype(np.int32)
        eids.flags.writeable = False
    if eids.size > 1:
        deltas = np.diff(eids)
        if deltas.min() >= 0 and deltas.max() < (1 << 16):
            d16 = deltas.astype(np.uint16)
            d16.flags.writeable = False
            # 2 bytes per gap + 4-byte anchor + uint16 dist
            return d16.nbytes + 6, int(dist), ("delta", int(eids[0]), d16)
    return eids.nbytes + 2, int(dist), ("raw", eids)


def _unpack_result(entry: tuple) -> tuple[int, np.ndarray]:
    """Decode a packed cache entry back to ``(dist, edge_ids int32)``.
    Decoded arrays are frozen like every shared result array."""
    _, dist, enc = entry
    if enc[0] == "raw":
        return dist, enc[1]
    _, first, d16 = enc
    eids = np.empty((d16.size + 1,), np.int32)
    eids[0] = first
    eids[1:] = d16
    np.cumsum(eids, out=eids)
    eids.flags.writeable = False
    return dist, eids


class ResultCache:
    """``(dist, edge_ids)`` cache keyed on the canonical query pair plus the
    serving epoch.  The cache itself is key-shape-agnostic; the ``protect``
    predicate only ever reads ``key[0]``/``key[1]``.

    Without ``protect`` this is a plain LRU.  With ``protect``,
    ``protected_frac`` of the capacity becomes *protected slots*: accepted
    keys live in their own LRU tier that cold traffic cannot evict
    (eviction drains the unprotected tier first; an overflowing protected
    tier *demotes* its LRU entry into the unprotected tier).

    Values live packed (``_pack_result``) and decode on ``get``;
    ``self.bytes`` tracks the packed payload bytes and ``capacity_bytes``
    optionally bounds them alongside the entry count.  ``capacity=0`` is a
    valid no-op cache.
    """

    def __init__(self, capacity: int, *,
                 protect: Callable[[tuple[int, int]], bool] | None = None,
                 protected_frac: float = 0.5,
                 capacity_bytes: int | None = None):
        if capacity < 0:
            raise ValueError("cache capacity must be non-negative")
        if capacity_bytes is not None and capacity_bytes < 0:
            raise ValueError("cache capacity_bytes must be non-negative")
        self.capacity = int(capacity)
        self.capacity_bytes = (
            None if capacity_bytes is None else int(capacity_bytes))
        self.protect = protect
        self.protected_cap = (
            max(1, int(capacity * protected_frac))
            if protect is not None and capacity else 0)
        # both tiers map key -> (nbytes, dist, enc) packed entries
        self._store: OrderedDict[tuple, tuple] = OrderedDict()  # unprotected
        self._protected: OrderedDict[tuple, tuple] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0   # entries dropped by capacity pressure
        self.bytes = 0       # packed payload bytes currently resident

    def __len__(self) -> int:
        return len(self._store) + len(self._protected)

    def __contains__(self, key: tuple) -> bool:
        return key in self._store or key in self._protected

    def get(self, key: tuple):
        for tier in (self._protected, self._store):
            got = tier.get(key)
            if got is not None:
                tier.move_to_end(key)
                self.hits += 1
                return _unpack_result(got)
        self.misses += 1
        return None

    def _evict_one(self) -> None:
        _, entry = (self._store or self._protected).popitem(last=False)
        self.bytes -= entry[0]
        self.evictions += 1

    def bytes_for(self, keys) -> int:
        """Packed resident bytes attributable to ``keys`` (absent keys
        contribute 0)."""
        total = 0
        for key in keys:
            entry = self._store.get(key)
            if entry is None:
                entry = self._protected.get(key)
            if entry is not None:
                total += entry[0]
        return total

    def put(self, key: tuple, value: tuple[int, np.ndarray]) -> None:
        self._insert_packed(key, _pack_result(value))

    def _insert_packed(self, key: tuple, entry: tuple) -> None:
        """Insert one already-packed ``(nbytes, dist, enc)`` entry (tier
        choice, demotion, capacity pressure)."""
        if self.capacity == 0:
            return
        # a key lives in exactly one tier; re-put refreshes tier + recency
        old = self._store.pop(key, None)
        if old is None:
            old = self._protected.pop(key, None)
        if old is not None:
            self.bytes -= old[0]
        self.bytes += entry[0]
        if self.protected_cap and self.protect(key):
            self._protected[key] = entry
            while len(self._protected) > self.protected_cap:
                k, v = self._protected.popitem(last=False)
                self._store[k] = v   # demote, don't drop
        else:
            self._store[key] = entry
        while len(self) > self.capacity:
            self._evict_one()
        if self.capacity_bytes is not None:
            while self.bytes > self.capacity_bytes and len(self):
                self._evict_one()

    def export_packed(self, pred=None, *, remove: bool = False) -> list:
        """Resident entries, packed: ``[(key, (nbytes, dist, enc)), ...]`` in
        LRU-to-MRU order per tier (unprotected, then protected).  ``pred``
        filters on the key; ``remove=True`` also evicts them (a move)."""
        out = []
        for tier in (self._store, self._protected):
            keys = [k for k in tier if pred is None or pred(k)]
            for k in keys:
                out.append((k, tier[k]))
                if remove:
                    entry = tier.pop(k)
                    self.bytes -= entry[0]
        return out

    def import_packed(self, entries) -> None:
        """Absorb entries exported by a peer's ``export_packed``, under this
        cache's own tier policy and capacity."""
        for key, entry in entries:
            self._insert_packed(key, entry)


class ServingService:
    """Planner-routed, chunk-overlapped executor over a built ``QbSIndex``
    or ``ShardedIndex``."""

    def __init__(self, index, *, async_depth: int = 2, cache_size: int = 0,
                 cache_policy: str = "lru", protected_frac: float = 0.5,
                 hub_top_frac: float = 0.01, cache_admission: str = "all",
                 cache_size_bytes: int | None = None,
                 chunk: int | None = None):
        self.index = index
        self.chunk = int(index.chunk if chunk is None else chunk)
        if self.chunk <= 0:
            raise ValueError("chunk must be positive")
        self.async_depth = max(1, int(async_depth))
        self.cache = None
        if cache_size or cache_size_bytes:
            if cache_policy == "lru":
                protect = None
            elif cache_policy == "hub":
                protect = self._hub_protect(hub_top_frac)
            else:
                raise ValueError(f"unknown cache_policy={cache_policy!r}")
            # byte-only provisioning: the packed payload bytes are the
            # capacity, the entry count is unbounded
            cap = cache_size if cache_size else (1 << 62)
            self.cache = ResultCache(cap, protect=protect,
                                     protected_frac=protected_frac,
                                     capacity_bytes=cache_size_bytes)
        # Cache *admission* is a separate axis from eviction: "all" inserts
        # every computed result; "reuse" inserts a key only when an endpoint
        # is a landmark/top-degree hub or on its second sighting (a bounded
        # shadow set records first sightings).
        if cache_admission not in ("all", "reuse"):
            raise ValueError(f"unknown cache_admission={cache_admission!r}")
        self.cache_admission = cache_admission
        self._seen_once: OrderedDict | None = None
        if self.cache is not None and cache_admission == "reuse":
            # share the eviction policy's predicate when there is one
            self._admit_hot = (self.cache.protect
                               if self.cache.protect is not None
                               else self._hub_protect(hub_top_frac))
            self._seen_once = OrderedDict()
            self._seen_cap = max(64, 4 * min(self.cache.capacity, 1 << 16))
        self.lane_served = [0] * N_LANES   # unique pairs answered per lane
        self.stats = {"installs": 0}        # service-level counters

    def install_index(self, index) -> None:
        """Swap in the next epoch's index (an ``apply_update`` product).
        Chunks dispatched before the swap hold the old epoch's tables, which
        ``apply_update`` never writes, so their results stay those of their
        admission epoch; cache keys carry the epoch, so earlier entries stop
        being reachable.  Callers serialize this against the query entry
        points (``StreamingService.install_index`` does, under its lock)."""
        if getattr(index, "is_sharded", False):
            raise ValueError("cannot install a sharded index")
        if index.epoch <= self.index.epoch:
            raise ValueError(
                f"install_index: epoch {index.epoch} is not ahead of "
                f"serving epoch {self.index.epoch}")
        self.index = index
        self.stats["installs"] += 1

    def _hub_protect(self, hub_top_frac: float):
        """Protect predicate of the hub policy: either endpoint is a
        landmark or a top-degree hub (``Graph.hub_mask``)."""
        prot = self.index._is_landmark_np | self.index.graph.hub_mask(
            top_frac=hub_top_frac)
        return lambda key: bool(prot[key[0]] or prot[key[1]])

    # -- lane dispatch -------------------------------------------------------

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            self.index.device)

    def _chunks(self, plan: QueryPlan, chunk: int | None = None):
        """Yield ``(unique_rows (chunk,), live, dispatch)`` per lane chunk;
        ``dispatch()`` runs the index's step and returns device tensors
        ``(dist (chunk,), edge_mask (chunk, E))``.  ``chunk`` overrides the
        service's width for this plan (the streaming layer picks it)."""
        chunk = self.chunk if chunk is None else int(chunk)
        idx = self.index
        lid = idx._lid_np

        for sel, live in chunk_padded(plan.lanes[LANE_GENERAL], chunk):
            yield sel, live, partial(idx.serve_step,
                                     self._tensor(plan.cu[sel]),
                                     self._tensor(plan.cv[sel]))

        for sel, live in chunk_padded(plan.lanes[LANE_LANDMARK_PAIR], chunk):
            yield sel, live, partial(idx.landmark_pair_step,
                                     self._tensor(lid[plan.cu[sel]]),
                                     self._tensor(lid[plan.cv[sel]]))

        one = plan.lanes[LANE_ONE_SIDED]
        if one.size:
            roots, r_idx = onesided_roots(plan.cu[one], plan.cv[one],
                                          idx._is_landmark_np, lid)
            for pos, live in chunk_padded(np.arange(one.size), chunk):
                yield one[pos], live, partial(idx.landmark_onesided_step,
                                              self._tensor(roots[pos]),
                                              self._tensor(r_idx[pos]))

    def _execute(self, plan: QueryPlan) -> Iterator[tuple]:
        """Drain all device lanes: yields host tuples ``(unique_rows,
        dist (L,), edge_ids [L sorted int32 arrays])`` with up to
        ``async_depth`` chunks in flight."""
        inflight: deque = deque()

        def drain(limit: int):
            while len(inflight) > limit:
                sel, live, (d, m) = inflight.popleft()
                yield (sel[:live], *edge_ids_of(d, m, live))

        for sel, live, dispatch in self._chunks(plan):
            inflight.append((sel, live, dispatch()))
            yield from drain(self.async_depth - 1)
        yield from drain(0)

    # -- cache ---------------------------------------------------------------

    def _cache_partition(self, plan: QueryPlan):
        """Pull cache hits out of the device lanes.  Returns the reduced
        plan plus ``[(unique_row, dist, edge_ids), ...]`` hits."""
        if self.cache is None:
            return plan, []
        hits = []
        epoch = self.index.epoch
        lanes = list(plan.lanes)
        for k in (LANE_LANDMARK_PAIR, LANE_ONE_SIDED, LANE_GENERAL):
            miss = []
            for row in lanes[k]:
                got = self.cache.get(
                    (int(plan.cu[row]), int(plan.cv[row]), epoch))
                if got is None:
                    miss.append(row)
                else:
                    hits.append((int(row), got[0], got[1]))
            lanes[k] = np.asarray(miss, dtype=np.intp)
        return plan._replace(lanes=tuple(lanes)), hits

    def cache_put(self, key: tuple[int, int, int],
                  value: tuple[int, np.ndarray]) -> None:
        """Insert a computed result through the cache admission policy (the
        one insertion path; the streaming scheduler routes through it too).
        ``key`` is the epoched cache key ``(u, v, epoch)``."""
        if self.cache is None:
            return
        if self._seen_once is not None and key not in self.cache \
                and not self._admit_hot(key):
            if key not in self._seen_once:       # predicted one-shot: skip
                self._seen_once[key] = None
                while len(self._seen_once) > self._seen_cap:
                    self._seen_once.popitem(last=False)
                return
            del self._seen_once[key]             # second sighting: admit
        self.cache.put(key, value)

    def _cache_put(self, plan: QueryPlan, row: int, dist: int,
                   eids: np.ndarray) -> None:
        self.cache_put(
            (int(plan.cu[row]), int(plan.cv[row]), self.index.epoch),
            (int(dist), eids))

    # -- answers -------------------------------------------------------------

    def _answer_unique(self, plan: QueryPlan):
        """Answer every unique pair: ``(dist (U,) int32, edge_ids list)``."""
        u_dist = np.full((plan.n_unique,), INF, np.int32)
        u_eids: list = [None] * plan.n_unique
        for row in plan.lanes[LANE_TRIVIAL]:
            u_dist[row] = 0
            u_eids[row] = _NO_EDGES
        for k in range(N_LANES):
            self.lane_served[k] += int(plan.lanes[k].size)
        plan, hits = self._cache_partition(plan)
        for row, d, eids in hits:
            u_dist[row] = d
            u_eids[row] = eids
        for rows, d, row_eids in self._execute(plan):
            for k, row in enumerate(rows):
                eids = row_eids[k]
                # frozen: duplicate queries and the cache share the array
                eids.flags.writeable = False
                u_dist[row] = d[k]
                u_eids[row] = eids
                if self.cache is not None:
                    self._cache_put(plan, row, int(d[k]), eids)
        return u_dist, u_eids

    def query_batch(self, us, vs) -> list:
        """Arbitrary batch -> per-query ``SPGResult`` list (original
        orientation preserved; dedup/canonicalization are internal).
        ``edge_ids`` arrays are read-only and may be shared between
        duplicate queries and with the result cache."""
        from ..core.qbs import SPGResult
        us = np.asarray(us, np.int32).reshape(-1)
        vs = np.asarray(vs, np.int32).reshape(-1)
        plan = plan_queries(us, vs, self.index._is_landmark_np)
        u_dist, u_eids = self._answer_unique(plan)
        out = []
        for i in range(plan.n):
            row = plan.inv[i]
            d = int(u_dist[row])
            out.append(SPGResult(u=int(us[i]), v=int(vs[i]), dist=d,
                                 edge_ids=u_eids[row],
                                 d_top=d_top_of(int(plan.lane[row]), d, INF)))
        return out

    def query_arrays(self, us, vs) -> tuple[np.ndarray, np.ndarray]:
        """Arbitrary batch -> raw ``(dist (N,) int32, edge_mask (N, E)
        bool)`` host arrays with no per-query result objects."""
        us = np.asarray(us, np.int32).reshape(-1)
        vs = np.asarray(vs, np.int32).reshape(-1)
        plan = plan_queries(us, vs, self.index._is_landmark_np)
        u_dist, u_eids = self._answer_unique(plan)
        mask = np.zeros((plan.n, self.index.graph.n_edges), bool)
        for i, row in enumerate(plan.inv):
            mask[i, u_eids[row]] = True
        return u_dist[plan.inv], mask
