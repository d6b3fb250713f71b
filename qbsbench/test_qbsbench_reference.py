"""The plain reference (``qbsbench/reference``) against networkx's
all-shortest-paths on small graphs: every edge of every shortest path,
the distance, ``u == v``, a hub (landmark-like) endpoint and pairs with no
path.  Its edge-slot layout is the one the served answers use."""
import itertools

import networkx as nx
import numpy as np
import pytest
import torch

from qbsbench.reference import UNREACHED, RefGraph, answer_pairs


def _grid(rows, cols):
    return np.array([(r * cols + c, r * cols + c + 1) for r in range(rows)
                     for c in range(cols - 1)]
                    + [(r * cols + c, (r + 1) * cols + c) for r in range(rows - 1)
                       for c in range(cols)], np.int64), rows * cols


def _split():
    # two components (a path and a triangle with a tail) and an isolated vertex
    e = np.array([(0, 1), (1, 2), (2, 3), (4, 5), (5, 6), (6, 4), (6, 7),
                  (1, 1), (2, 1)], np.int64)       # a self-loop and a duplicate
    return e, 9


GRAPHS = {
    "ba": (np.array(nx.barabasi_albert_graph(60, 3, seed=4).edges, np.int64), 60),
    "ba_mixed_m": (np.array(nx.dual_barabasi_albert_graph(50, 2, 3, 0.5, seed=9).edges,
                            np.int64), 50),
    "grid": _grid(5, 6),
    "split": _split(),
}


def _expected(edges, n, u, v):
    g = nx.Graph()
    g.add_nodes_from(range(n))
    g.add_edges_from((int(a), int(b)) for a, b in edges if a != b)
    if u == v:
        return 0, set()
    if not nx.has_path(g, u, v):
        return None, set()
    on = set()
    for path in nx.all_shortest_paths(g, u, v):
        on |= {(min(a, b), max(a, b)) for a, b in zip(path, path[1:])}
    return nx.shortest_path_length(g, u, v), on


def _pairs(n, edges):
    deg = np.bincount(np.asarray(edges).ravel(), minlength=n)
    hub = int(np.argmax(deg))
    rng = np.random.default_rng(0)
    pairs = [(hub, int(x)) for x in rng.integers(0, n, 6)]      # hub endpoint
    pairs += [(int(a), int(b)) for a, b in rng.integers(0, n, (20, 2))]
    pairs += [(3, 3), (0, n - 1), (n - 1, 0)]
    return pairs


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_reference_matches_networkx(name):
    edges, n = GRAPHS[name]
    g = RefGraph(edges, n)
    src, dst = g.src.numpy(), g.dst.numpy()
    pairs = _pairs(n, edges)
    us, vs = zip(*pairs)
    seen = 0
    for i, d, slots in answer_pairs(g, np.array(us), np.array(vs), sources=8):
        want_d, want = _expected(edges, n, us[i], vs[i])
        assert d == (UNREACHED if want_d is None else want_d), pairs[i]
        got = {(min(a, b), max(a, b)) for a, b in zip(src[slots], dst[slots])}
        assert got == want, pairs[i]
        # both orientations of every edge on the graph, sorted slot ids
        assert slots.size == 2 * len(want) and np.all(np.diff(slots) > 0)
        seen += 1
    assert seen == len(pairs)


def test_unreachable_and_trivial_pairs():
    edges, n = GRAPHS["split"]
    g = RefGraph(edges, n)
    got = {i: (d, s.size) for i, d, s in
           answer_pairs(g, np.array([0, 0, 8, 4]), np.array([4, 0, 8, 7]))}
    assert got == {0: (UNREACHED, 0), 1: (0, 0), 2: (0, 0), 3: (2, 4)}


def test_blocked_vertices_reroute_the_search():
    edges, n = _grid(3, 3)             # 0-1-2 / 3-4-5 / 6-7-8
    g = RefGraph(edges, n)
    blocked = np.zeros((n,), bool)
    blocked[[1, 4]] = True
    (_, d, slots), = answer_pairs(g, np.array([0]), np.array([2]), blocked=blocked)
    assert d == 6 and slots.size == 12   # around through 3, 6, 7, 8, 5


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_slot_layout_is_the_served_one(name):
    """The slot ids the served answers use are those of ``from_edges``'s
    canonical layout, which the reference derives itself."""
    from repro_torch.core import from_edges

    edges, n = GRAPHS[name]
    g = RefGraph(edges, n)
    served = from_edges(edges, n, device="cpu")
    assert torch.equal(served.src.to(torch.int64), g.src)
    assert torch.equal(served.dst.to(torch.int64), g.dst)


def test_block_sizes_do_not_change_answers():
    edges, n = GRAPHS["ba"]
    g = RefGraph(edges, n)
    pairs = list(itertools.islice(itertools.product(range(0, n, 7), repeat=2), 40))
    us, vs = map(np.array, zip(*pairs))
    a = [(d, s.tolist()) for _, d, s in answer_pairs(g, us, vs, sources=2)]
    b = [(d, s.tolist()) for _, d, s in answer_pairs(g, us, vs, sources=256)]
    assert a == b
