"""Query planner: lane classification and batch canonicalization for SPG
serving.  A copy of ``repro.serving.planner`` (host-only numpy; the port
imports nothing of the reference package).

Every serving entry point answers an arbitrary ``(us, vs)`` batch through
the same two steps: *plan* (this module, host-side numpy) and *execute*
(``serving.service``).  The planner owns all routing policy:

* **Canonicalize + dedup.**  SPGs on an undirected graph are orientation-
  and repetition-invariant, so queries are keyed on ``(min(u, v),
  max(u, v))`` and deduplicated; the executor answers each *unique* pair
  once and the plan's ``inv`` map fans results back out.
* **Lanes.**  Each unique pair lands in one of four lanes, in decreasing
  strictness:

  - ``LANE_TRIVIAL``        ``u == v``: dist 0, no edges, no device work.
  - ``LANE_LANDMARK_PAIR``  both endpoints are landmarks: distance is a
    ``meta_dist`` lookup and every SPG edge certifies label-only
    (``QbSIndex.landmark_pair_step``); no search at all.
  - ``LANE_ONE_SIDED``      exactly one landmark endpoint: label-derived
    distance + one *distance-bounded* full-graph BFS from the non-landmark
    side, batched over the whole lane
    (``QbSIndex.landmark_onesided_step``).
  - ``LANE_GENERAL``        no landmark endpoint: the sketch + guided
    search pipeline (``QbSIndex.serve_step``).

Each device lane runs in fixed-shape chunks (``chunk_padded``; ragged
tails repeat the last live entry and the pad lanes are discarded).  The
planner never touches a device.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np

LANE_TRIVIAL = 0
LANE_LANDMARK_PAIR = 1
LANE_ONE_SIDED = 2
LANE_GENERAL = 3
N_LANES = 4

LANE_NAMES = ("trivial", "landmark_pair", "one_sided", "general")


class QueryPlan(NamedTuple):
    """Routed batch: unique canonical pairs + per-lane index sets.

    ``cu``/``cv`` are the canonical (min, max) endpoints of the unique
    pairs; ``inv`` maps each of the ``n`` original queries to its unique
    row; ``lane`` assigns each unique row a lane id; ``lanes[k]`` lists the
    unique-row indices of lane ``k`` in first-appearance order.
    """

    n: int                       # original batch size
    cu: np.ndarray               # (U,) int32 canonical min endpoint
    cv: np.ndarray               # (U,) int32 canonical max endpoint
    inv: np.ndarray              # (n,) intp query -> unique row
    lane: np.ndarray             # (U,) int8
    lanes: tuple[np.ndarray, ...]  # per-lane unique-row indices
    cls: np.ndarray | None = None  # (U,) int16 QoS class id (None: untagged)

    @property
    def n_unique(self) -> int:
        return int(self.cu.shape[0])


def classify_lanes(cu: np.ndarray, cv: np.ndarray,
                   is_landmark: np.ndarray) -> np.ndarray:
    """Lane id per canonical pair (the one routing rule, shared by every
    plan constructor)."""
    lm_u = is_landmark[cu]
    lm_v = is_landmark[cv]
    return np.where(
        cu == cv, LANE_TRIVIAL,
        np.where(lm_u & lm_v, LANE_LANDMARK_PAIR,
                 np.where(lm_u ^ lm_v, LANE_ONE_SIDED, LANE_GENERAL)),
    ).astype(np.int8)


def d_top_of(lane: int, dist: int, inf: int) -> int:
    """The one d_top reporting convention (seed pipeline): general-lane
    answers report the dist-derived d_top; planner-answered lanes
    (trivial, both landmark lanes, cache hits thereof) report ``inf``
    because no sketch ran for them.  Shared by the one-shot service and
    every streaming resolution path so the convention cannot drift."""
    return dist if (lane == LANE_GENERAL and dist < inf) else inf


def plan_queries(us: np.ndarray, vs: np.ndarray,
                 is_landmark: np.ndarray,
                 cls: np.ndarray | None = None) -> QueryPlan:
    """Classify a query batch into lanes over canonical unique pairs.

    ``cls`` optionally tags each *original* query with a QoS class id;
    the unique row keeps the class of its first appearance (the class
    that got the pair admitted — later duplicates join, they don't
    re-route)."""
    us = np.asarray(us, np.int32).reshape(-1)
    vs = np.asarray(vs, np.int32).reshape(-1)
    n = us.shape[0]
    cu = np.minimum(us, vs)
    cv = np.maximum(us, vs)
    # stable dedup: unique rows keep first-appearance order so execution
    # order (and thus device dispatch order) is reproducible
    # int64 on purpose: the dedup key is a (u * (V+1) + v) product that can
    # exceed int32 for large V — it is transient, never a resident table
    key = cu.astype(np.int64) * (int(is_landmark.shape[0]) + 1) + cv  # qbslint: disable=QBS007
    _, first, inv = np.unique(key, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    first = first[order]
    inv = rank[inv]
    cu, cv = cu[first], cv[first]

    lane = classify_lanes(cu, cv, is_landmark)
    lanes = tuple(np.flatnonzero(lane == k) for k in range(N_LANES))
    u_cls = (None if cls is None
             else np.asarray(cls, np.int16).reshape(-1)[first])
    return QueryPlan(n=n, cu=cu, cv=cv, inv=inv.astype(np.intp), lane=lane,
                     lanes=lanes, cls=u_cls)


def plan_from_pairs(cu: np.ndarray, cv: np.ndarray,
                    is_landmark: np.ndarray,
                    cls: np.ndarray | None = None) -> QueryPlan:
    """Plan a set of *already canonical, already unique* pairs (``cu <=
    cv``, no repeats) without re-running canonicalization or dedup.

    The streaming scheduler (``serving.stream``) keys its pending and
    in-flight state on canonical pairs, so by the time it admits a batch
    the dedup work is already done; ``inv`` is the identity.  ``cls``
    carries the per-pair QoS class lane the scheduler selected from."""
    cu = np.asarray(cu, np.int32).reshape(-1)
    cv = np.asarray(cv, np.int32).reshape(-1)
    lane = classify_lanes(cu, cv, is_landmark)
    lanes = tuple(np.flatnonzero(lane == k) for k in range(N_LANES))
    u_cls = None if cls is None else np.asarray(cls, np.int16).reshape(-1)
    return QueryPlan(n=cu.shape[0], cu=cu, cv=cv,
                     inv=np.arange(cu.shape[0], dtype=np.intp), lane=lane,
                     lanes=lanes, cls=u_cls)


def merge_plans(plans: list[QueryPlan],
                is_landmark: np.ndarray) -> QueryPlan:
    """Coalesce several planned batches into one plan, re-deduplicating
    *across* plan boundaries — the admission-control primitive: queries
    arriving at different times fold into a single planner batch, and a
    pair appearing in two admissions executes once.

    The merged ``inv`` indexes the concatenation of the source plans'
    original queries (in plan order), so per-query fan-out survives the
    merge.  QoS class tags survive it too (first appearance wins, like
    the dedup itself); plans without tags contribute class 0."""
    if not plans:
        return plan_queries(np.zeros((0,), np.int32), np.zeros((0,), np.int32),
                            is_landmark)
    if len(plans) == 1:
        return plans[0]
    # reconstruct each plan's original canonical stream and re-plan; the
    # pairs are already canonical (cu <= cv), so plan_queries' min/max
    # canonicalization is a no-op and only the cross-plan dedup bites
    cu = np.concatenate([p.cu[p.inv] for p in plans])
    cv = np.concatenate([p.cv[p.inv] for p in plans])
    cls = None
    if any(p.cls is not None for p in plans):
        cls = np.concatenate([
            (p.cls[p.inv] if p.cls is not None
             else np.zeros((p.n,), np.int16)) for p in plans])
    return plan_queries(cu, cv, is_landmark, cls=cls)


def chunk_padded(idx: np.ndarray, chunk: int) -> Iterator[tuple[np.ndarray, int]]:
    """Yield fixed-shape ``(sel (chunk,), live)`` index chunks of ``idx``;
    the ragged tail repeats the last live entry (pad lanes are computed
    and discarded — the fixed shape is what keeps one jit cache entry per
    lane)."""
    for start in range(0, idx.size, chunk):
        sel = idx[start:start + chunk]
        live = sel.size
        if live < chunk:
            sel = np.concatenate([sel, np.repeat(sel[-1:], chunk - live)])
        yield sel, live


def onesided_roots(cu: np.ndarray, cv: np.ndarray, is_landmark: np.ndarray,
                   lid: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split one-sided-lane pairs into (non-landmark root, landmark index)."""
    u_is = is_landmark[cu]
    roots = np.where(u_is, cv, cu).astype(np.int32)
    r_idx = lid[np.where(u_is, cu, cv)].astype(np.int32)
    return roots, r_idx
