"""Seeded graph generator of the benchmark (host numpy, vectorised).

``chung_lu`` draws a graph with a dataset's published vertex count, edge
count and top degree.  The degrees are Chung-Lu weights (Chung and Lu,
"Connected components in random graphs with given expected degree
sequences", 2002), ``w_i = max_degree * ((i + i0) / i0) ** -a``, a power
law ``P(d) ~ d ** -(1 + 1 / a)``, with ``i0`` and ``a`` fitted so that the
top weight is ``max_degree``, the last is ``min_degree`` and they sum to
twice the edge count, rounded to whole degrees.  The stubs are paired at
random (the configuration model), self-loops and
repeated pairs are rewired away, and the components other than the
largest are joined to it, all by degree-preserving swaps: the graph is
simple and connected, as the datasets are (nearly), and has that degree
sequence and edge count exactly.  Vertex ids are shuffled last, so no id
order follows the degree.
"""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

GRAPH_STREAM = 1   # the seed's stream for graphs (traffic uses others)


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for ``seed`` (any whole number) and a stream id."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def chung_lu_weights(n: int, stubs: float, max_degree: int, min_degree: int):
    """``(weights, exponent)``: the Chung-Lu weights ``w_i = max_degree *
    ((i + i0) / i0) ** -a``, highest first, with ``i0`` and ``a`` fitted so
    that the last weight is ``min_degree`` and the weights sum to
    ``stubs``.  The degree law is then ``P(d) ~ d ** -(1 + 1 / a)``."""
    i = np.arange(n, dtype=np.float64)
    span = np.log(max_degree / min_degree)

    def at(i0):
        a = span / np.log1p((n - 1) / i0)
        return max_degree * (1.0 + i / i0) ** -a, a

    lo, hi = np.log(1e-3), np.log(1e7)     # the sum grows with i0
    for _ in range(48):
        mid = 0.5 * (lo + hi)
        if at(np.exp(mid))[0].sum() > stubs:
            hi = mid
        else:
            lo = mid
    return at(np.exp(0.5 * (lo + hi)))


def degree_sequence(n: int, n_edges: int, max_degree: int, min_degree: int) -> np.ndarray:
    """The fitted weights rounded to degrees, highest first, with exactly
    ``2 n_edges`` stubs: what rounding leaves over or short is taken from,
    or given to, the lowest degrees one stub each."""
    w, _ = chung_lu_weights(n, 2.0 * n_edges, max_degree, min_degree)
    d = np.maximum(np.rint(w), min_degree).astype(np.int64)
    short = 2 * n_edges - int(d.sum())
    if short > 0:
        d[n - short:] += 1
    elif short < 0:
        d[np.flatnonzero(d > min_degree)[short:]] -= 1
    return np.sort(d)[::-1]


def _simple(e: np.ndarray, deg: np.ndarray, rng) -> np.ndarray:
    """Make a stub pairing simple without changing a degree: each self-loop
    or repeated pair ``(p, q)`` and a random edge ``(x, y)`` between two
    vertices under the structural cutoff ``sqrt(2 M)`` become ``(p, x)``
    and ``(q, y)``, in rounds until none is left.  Returns the keys
    ``low * n + high``."""
    n = deg.size
    lo, hi = np.minimum(e[:, 0], e[:, 1]), np.maximum(e[:, 0], e[:, 1])
    keys = np.sort(lo[lo != hi] * n + hi[lo != hi])
    first = np.ones(keys.size, bool)
    first[1:] = keys[1:] != keys[:-1]
    good = keys[first]
    pend = np.concatenate([e[lo == hi], np.stack([keys[~first] // n, keys[~first] % n], 1)])
    alive = np.ones(good.size, bool)
    cutoff = np.sqrt(2.0 * e.shape[0])
    pool = np.flatnonzero((deg[good // n] < cutoff) & (deg[good % n] < cutoff))
    pool = pool[rng.permutation(pool.size)]
    taken = 0
    added = np.array([np.iinfo(np.int64).max])     # a sentinel past every key
    while pend.shape[0]:
        if taken + pend.shape[0] > pool.size:
            raise RuntimeError("the degree sequence did not become simple")
        j = pool[taken:taken + pend.shape[0]]
        taken += j.size
        alive[j] = False
        x, y = good[j] // n, good[j] % n
        flip = rng.random(j.size) < 0.5
        x, y = np.where(flip, y, x), np.where(flip, x, y)
        cand = np.concatenate([np.stack([pend[:, 0], x], 1), np.stack([pend[:, 1], y], 1)])
        ck = np.minimum(cand[:, 0], cand[:, 1]) * n + np.maximum(cand[:, 0], cand[:, 1])
        pos = np.minimum(np.searchsorted(good, ck), good.size - 1)
        ok = ((cand[:, 0] != cand[:, 1]) & ~((good[pos] == ck) & alive[pos])
              & (added[np.searchsorted(added, ck)] != ck))
        first = np.zeros(ck.size, bool)
        first[np.unique(np.where(ok, ck, -1), return_index=True)[1]] = True
        ok &= first
        added = np.sort(np.concatenate([added, ck[ok]]))
        pend = cand[~ok]
    return np.concatenate([good[alive], added[:-1]])


def _components(e: np.ndarray, n: int) -> np.ndarray:
    adj = coo_matrix((np.ones(e.shape[0], np.int8), (e[:, 0], e[:, 1])), shape=(n, n))
    return connected_components(adj, directed=False)[1]


def _connect(e: np.ndarray, n: int, rng) -> np.ndarray:
    """Join every component to the largest by degree-preserving swaps: an
    edge ``(a, b)`` of each other component and a random edge ``(c, d)``
    of the largest become ``(a, c)`` and ``(b, d)``; rounds until one
    component is left (a swap that cuts a bridge splits the largest, and
    the next round joins it again)."""
    while True:
        label = _components(e, n)
        if label.max() == 0:
            return e
        big = int(np.argmax(np.bincount(label)))
        lab_e = label[e[:, 0]]
        # edges of the largest between vertices of degree 2 or more, so that
        # a swap seldom cuts a leaf off
        deg = np.bincount(e.ravel(), minlength=n)
        inside = np.flatnonzero((lab_e == big) & (deg[e[:, 0]] > 1) & (deg[e[:, 1]] > 1))
        outside = np.flatnonzero(lab_e != big)
        # one edge of each other component, drawn from rng
        outside = outside[rng.permutation(outside.size)]
        mine = outside[np.unique(lab_e[outside], return_index=True)[1]]
        picks = inside[rng.choice(inside.size, size=mine.size, replace=False)]
        new = np.concatenate([np.stack([e[mine, 0], e[picks, 0]], 1),
                              np.stack([e[mine, 1], e[picks, 1]], 1)])
        keep = np.ones(e.shape[0], bool)
        keep[mine] = False
        keep[picks] = False
        e = np.concatenate([e[keep], new])


def chung_lu(n_vertices: int, n_edges: int, max_degree: int, min_degree: int,
                seed: int) -> np.ndarray:
    """``(n_edges, 2)`` int32 undirected edges, simple and connected, with
    the fitted degree sequence exactly, drawn from ``seed``."""
    n = int(n_vertices)
    if not min_degree < max_degree < n:
        raise ValueError("need min_degree < max_degree < n_vertices")
    deg = degree_sequence(n, int(n_edges), int(max_degree), int(min_degree))
    rng = rng_for(seed, GRAPH_STREAM)
    stubs = rng.permutation(np.repeat(np.arange(n, dtype=np.int64), deg))
    keys = _simple(stubs.reshape(-1, 2), deg, rng)
    e = _connect(np.stack([keys // n, keys % n], axis=1), n, rng)
    return rng.permutation(n)[e].astype(np.int32)


GENERATORS = {"chung_lu": chung_lu}


def scaled(spec: dict, n_vertices: int) -> dict:
    """A configuration's ``graph`` block at ``n_vertices`` (the tests'
    small sizes): the same mean degree, the top degree in the same
    proportion to the vertex count."""
    r = n_vertices / int(spec["n_vertices"])
    return dict(spec, n_vertices=n_vertices,
                n_edges=int(round(int(spec["n_edges"]) * r)),
                max_degree=max(int(spec["min_degree"]) + 1,
                               int(round(int(spec["max_degree"]) * r))))


def generate(spec: dict) -> tuple[np.ndarray, int]:
    """A configuration's ``graph`` block -> ``(edges (M, 2) int32,
    n_vertices)``.  The graph is drawn from the block's own ``seed``, not
    from a run's: every run of a configuration serves the same graph, and
    the run's seed draws the traffic on it."""
    gen = GENERATORS[spec["generator"]]
    n = int(spec["n_vertices"])
    return gen(n, int(spec["n_edges"]), int(spec["max_degree"]),
               int(spec["min_degree"]), int(spec["seed"])), n


def cached(spec: dict, cache_dir: Path) -> tuple[np.ndarray, int]:
    """``generate(spec)``, kept in ``cache_dir`` as ``<key>.npy``, the key
    the SHA-256 of the graph block and of this module's source: a changed
    block or generator misses, and a miss generates the graph and writes
    the file (under a partial name first, so a run that dies mid-write
    leaves no file that a later run would read)."""
    h = hashlib.sha256(json.dumps(spec, sort_keys=True).encode())
    h.update(Path(__file__).read_bytes())
    path = Path(cache_dir) / f"{h.hexdigest()}.npy"
    if path.exists():
        return np.load(path), int(spec["n_vertices"])
    edges, n = generate(spec)
    path.parent.mkdir(parents=True, exist_ok=True)
    part = path.with_name(path.name + ".part")
    with open(part, "wb") as f:
        np.save(f, edges)
    os.replace(part, path)
    return edges, n
