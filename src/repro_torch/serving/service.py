"""SPG serving service: lane execution over a ``QueryPlan``.
Counterpart of ``repro.serving.service`` (the default path: no result
cache, one device).

The planner owns *what* runs (``serving.planner``); the service owns *how*:
every lane chunk is a device step returning device tensors, and the
service keeps up to ``async_depth`` chunks in flight (a deque), copying the
oldest to the host only when the window is full.  The drain's ``.cpu()``
is the reference's ``jax.device_get``.  ``async_depth=1`` is the strictly
synchronous dispatch-then-copy loop.

The result cache, cache admission, ``install_index`` and the multi-device
``mesh=``/``devices=`` modes of the reference are not ported yet.
"""
from __future__ import annotations

from collections import deque
from functools import partial
from typing import Iterator

import numpy as np
import torch

from ..core.graph import INF
from .planner import (
    LANE_GENERAL,
    LANE_LANDMARK_PAIR,
    LANE_ONE_SIDED,
    LANE_TRIVIAL,
    QueryPlan,
    chunk_padded,
    d_top_of,
    onesided_roots,
    plan_queries,
)

_NO_EDGES = np.zeros((0,), np.int32)   # edge counts fit int32 (E << 2^31)
_NO_EDGES.flags.writeable = False   # shared by every trivial-lane result


class ServingService:
    """Planner-routed, chunk-overlapped executor over a built ``QbSIndex``."""

    def __init__(self, index, *, async_depth: int = 2, chunk: int | None = None):
        self.index = index
        self.chunk = int(index.chunk if chunk is None else chunk)
        if self.chunk <= 0:
            raise ValueError("chunk must be positive")
        self.async_depth = max(1, int(async_depth))

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            self.index.device)

    def _chunks(self, plan: QueryPlan):
        """Yield ``(unique_rows (chunk,), live, dispatch)`` per lane chunk;
        ``dispatch()`` enqueues the device step and returns device tensors
        ``(dist (chunk,), edge_mask (chunk, E))``."""
        chunk = self.chunk
        idx = self.index
        lid = idx._lid_np

        for sel, live in chunk_padded(plan.lanes[LANE_GENERAL], chunk):
            yield sel, live, partial(idx.serve_step, self._tensor(plan.cu[sel]),
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
                # the SPG edges leave the device as row-major (row, slot)
                # pairs, a few KB instead of the (L, E) mask; per row they
                # come out ascending, as flatnonzero of the mask row would
                nz = torch.nonzero(m[:live]).cpu().numpy()
                d = d[:live].cpu().numpy()
                cuts = np.searchsorted(nz[:, 0], np.arange(1, live))
                yield sel[:live], d, np.split(nz[:, 1].astype(np.int32), cuts)

        for sel, live, dispatch in self._chunks(plan):
            inflight.append((sel, live, dispatch()))
            yield from drain(self.async_depth - 1)
        yield from drain(0)

    def _answer_unique(self, plan: QueryPlan):
        """Answer every unique pair: ``(dist (U,) int32, edge_ids list)``."""
        u_dist = np.full((plan.n_unique,), INF, np.int32)
        u_eids: list = [None] * plan.n_unique
        for row in plan.lanes[LANE_TRIVIAL]:
            u_dist[row] = 0
            u_eids[row] = _NO_EDGES
        for rows, d, row_eids in self._execute(plan):
            for k, row in enumerate(rows):
                eids = row_eids[k]
                # frozen: duplicate queries share the array
                eids.flags.writeable = False
                u_dist[row] = d[k]
                u_eids[row] = eids
        return u_dist, u_eids

    def query_batch(self, us, vs) -> list:
        """Arbitrary batch -> per-query ``SPGResult`` list (original
        orientation preserved; dedup/canonicalization are internal)."""
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
