"""The one traffic generator: a traffic file's parameters -> query pairs and
arrival times, drawn from the run's seed (host numpy).

Pair kinds (``pairs.kind`` in a closed-loop file):

* ``uniform`` - u and v uniform over all vertices (the paper's random-pair
  query workload).
* ``walk`` - u uniform, v the end of a simple random walk from u whose
  length is uniform in ``[min_steps, max_steps]`` (friends of friends);
  ``u == v`` pairs are kept as the walk gives them.

An open-loop file (``schedule``) gives a fixed count of arrivals,
``round(rate_qps * seconds)``, over the window: the interactive class at
exponential gaps (a Poisson stream), the bulk class (``bulk_share`` of
the count) in bursts whose lengths run through ``[burst_len[0],
burst_len[1])`` and whose arrivals fall inside ``burst_span_us``.
Endpoints are drawn by degree rank, ``rank = floor(x ** rank_alpha * V)``
for x uniform, so they lean to the hubs; a
``repeat_p`` share of the arrivals repeats one of the last ``recent``
freshly drawn pairs instead.  Pairs are drawn in arrival order.  The
timeline is the file's own; a run's seed picks the vertices
(``stream_schedule``), so every seed offers the same work.
"""
from __future__ import annotations

from collections import deque

import numpy as np

from .graphgen import rng_for

TRAFFIC_STREAM = 2    # window traffic
WARMUP_STREAM = 3     # warm-up traffic, never the window's pairs


class HostGraph:
    """What the generator needs of the graph: CSR rows and degree ranks,
    worked out from the edge list."""

    def __init__(self, edges: np.ndarray, n_vertices: int):
        e = np.asarray(edges)
        src = np.concatenate([e[:, 0], e[:, 1]]).astype(np.int32)
        dst = np.concatenate([e[:, 1], e[:, 0]]).astype(np.int32)
        order = np.argsort(src, kind="stable")
        self.nbrs = dst[order]
        self.deg = np.bincount(src, minlength=n_vertices)
        self.indptr = np.zeros((n_vertices + 1,), np.int64)
        np.cumsum(self.deg, out=self.indptr[1:])
        self.n = n_vertices

    def by_rank(self, rng) -> np.ndarray:
        """Vertices by degree, highest first, ties in an order drawn from
        ``rng``."""
        return np.lexsort((rng.permutation(self.n), -self.deg)).astype(np.int32)


def uniform_pairs(g: HostGraph, rng, b: int):
    return (rng.integers(0, g.n, size=b).astype(np.int32),
            rng.integers(0, g.n, size=b).astype(np.int32))


def walk_pairs(g: HostGraph, rng, b: int, min_steps: int, max_steps: int):
    u = rng.integers(0, g.n, size=b).astype(np.int32)
    steps = rng.integers(min_steps, max_steps + 1, size=b)
    x = u.astype(np.int64)
    for s in range(max_steps):
        lo = g.indptr[x]
        deg = g.indptr[x + 1] - lo
        j = (rng.random(b) * deg).astype(np.int64)
        nxt = g.nbrs[lo + np.minimum(j, deg - 1)]
        x = np.where(s < steps, nxt, x)
    return u, x.astype(np.int32)


def batch_pairs(traffic: dict, g: HostGraph, seed: int, i: int,
                stream: int = TRAFFIC_STREAM):
    """Batch ``i`` of a closed-loop mix: ``(us, vs)`` int32."""
    rng = rng_for(seed, stream, i)
    p = traffic["pairs"]
    b = int(traffic["batch"])
    if p["kind"] == "uniform":
        return uniform_pairs(g, rng, b)
    if p["kind"] == "walk":
        return walk_pairs(g, rng, b, int(p["min_steps"]), int(p["max_steps"]))
    raise ValueError(f"unknown pair kind {p['kind']!r}")


def _exp_gaps(n: int, mean: float, rng) -> np.ndarray:
    """``n`` exponential gaps of ``mean`` as one fixed multiset (the
    distribution's quantiles at ``(i + 0.5) / n``), in an order drawn from
    ``rng``."""
    q = (np.arange(n) + 0.5) / max(n, 1)
    return rng.permutation(-np.log1p(-q) * mean)


def _times(n: int, horizon: float, rng) -> np.ndarray:
    """``n`` ascending arrival times in ``[0, horizon)`` whose gaps are
    ``_exp_gaps``: a Poisson stream with its count and its gaps fixed."""
    g = _exp_gaps(n, 1.0, rng)
    return np.cumsum(g) * (horizon / (g.sum() + 1.0))


def stream_schedule(traffic: dict, g: HostGraph, seed: int, seconds: float,
                    *, rate: float | None = None,
                    stream: int = TRAFFIC_STREAM) -> dict:
    """The open-loop arrivals of one window: arrays ``t`` (s from the
    window's start, ascending), ``cls`` (index into ``traffic['qos']``; 0
    interactive, 1 bulk), ``u``, ``v``, ``repeat`` (bool) and ``burst``
    (burst id, -1 for interactive).

    The timeline (arrival times, classes, bursts, which arrivals repeat and
    the degree rank of every endpoint) is drawn from the file's own
    ``schedule.seed``, with fixed multisets of gaps, burst lengths and rank
    draws; the run's seed decides which vertex of a degree stands at each
    rank.  So every seed offers the same arrivals of the same sizes, on
    other vertices of the same degrees."""
    s = traffic["schedule"]
    rng = rng_for(int(s["seed"]), stream)
    by_rank = g.by_rank(rng_for(seed, stream))
    n = int(round((s["rate_qps"] if rate is None else rate) * seconds))
    n_bulk = int(n * float(s["bulk_share"]))
    t_int = _times(n - n_bulk, seconds, rng)
    lo, hi = s["burst_len"]
    span = float(s["burst_span_us"]) * 1e-6
    lens: list = []
    if n_bulk:
        cycle = np.arange(lo, hi)
        lens = rng.permutation(np.tile(cycle, n_bulk // int(cycle.sum()) + 1)).tolist()
        # the shortest prefix that covers the bulk count, its last burst cut
        lens = lens[:int(np.searchsorted(np.cumsum(lens), n_bulk)) + 1]
        lens[-1] -= sum(lens) - n_bulk
    starts = _times(len(lens), max(seconds - span, 0.0), rng)
    t_bulk = np.concatenate(
        [st + (np.arange(k) + 0.5) / k * span for st, k in zip(starts, lens)]
        or [np.zeros((0,))])
    burst = np.concatenate([np.full((n - n_bulk,), -1, np.int64)] + [
        np.full((k,), j, np.int64) for j, k in enumerate(lens)])
    t = np.concatenate([t_int, t_bulk])
    cls = np.concatenate([np.zeros((n - n_bulk,), np.int64),
                          np.ones((n_bulk,), np.int64)])
    order = np.argsort(t, kind="stable")
    t, cls, burst = t[order], cls[order], burst[order]

    rep = np.zeros((n,), bool)
    n_rep = int(round(float(s["repeat_p"]) * max(n - 1, 0)))
    rep[1 + rng.permutation(max(n - 1, 0))[:n_rep]] = True
    n_fresh = n - n_rep
    alpha = float(s["rank_alpha"])
    q = (np.arange(n_fresh) + 0.5) / max(n_fresh, 1)
    ranks = [np.minimum((rng.permutation(q) ** alpha * g.n).astype(np.int64), g.n - 1)
             for _ in range(2)]
    pick = rng.random(n)
    recent: deque = deque(maxlen=int(s["recent"]))
    u = np.empty((n,), np.int32)
    v = np.empty((n,), np.int32)
    j = 0
    for i in range(n):
        if rep[i]:
            u[i], v[i] = recent[int(pick[i] * len(recent))]
            continue
        pair = (int(by_rank[ranks[0][j]]), int(by_rank[ranks[1][j]]))
        j += 1
        recent.append(pair)
        u[i], v[i] = pair
    return {"t": t, "cls": cls, "u": u, "v": v, "repeat": rep, "burst": burst}
