"""The benchmark's generators on the CPU: the vectorised Chung-Lu graph
(same edges for the same seed, simple and connected, the stated vertex
and edge counts and the fitted degree sequence exactly) and the three
traffic mixes (same pairs for the same seed; the stream's bulk share,
repeat share and burst lengths match their knobs within sampling error);
the graph cache returns what the generator drew, and a changed graph
block misses it."""
import json
from pathlib import Path

import numpy as np
import pytest
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components, shortest_path

from qbsbench import graphgen
from qbsbench.graphgen import chung_lu, chung_lu_weights, degree_sequence, generate, scaled
from qbsbench.trafficgen import HostGraph, batch_pairs, stream_schedule

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
TRAFFIC = {n: json.loads((BENCH / "traffic" / f"{n}.json").read_text())
           for n in ("uniform-batch", "local-batch", "hub-stream")}
CONFIGS = {n: json.loads((BENCH / "configs" / f"{n}.json").read_text())
           for n in ("youtube-r20", "skitter-r20")}
BIG_SEED = 2**31 + 12345


def _components(edges, n):
    a = coo_matrix((np.ones(len(edges)), (edges[:, 0], edges[:, 1])), shape=(n, n))
    return connected_components(a, directed=False)[0]


@pytest.mark.parametrize("name, n", [("youtube-r20", 5000), ("skitter-r20", 5000)])
def test_graph_counts_connected_and_simple(name, n):
    g = scaled(CONFIGS[name]["graph"], n)
    e = chung_lu(n, g["n_edges"], g["max_degree"], g["min_degree"], BIG_SEED)
    assert e.shape == (g["n_edges"], 2) and e.dtype == np.int32
    assert e.min() >= 0 and e.max() == n - 1
    assert not np.any(e[:, 0] == e[:, 1])
    keys = np.minimum(e[:, 0], e[:, 1]).astype(np.int64) * n + np.maximum(e[:, 0], e[:, 1])
    assert np.unique(keys).size == e.shape[0]           # no duplicate edge
    assert _components(e, n) == 1
    deg = np.bincount(e.ravel(), minlength=n)
    want = degree_sequence(n, g["n_edges"], g["max_degree"], g["min_degree"])
    assert np.array_equal(np.sort(deg)[::-1], want)      # the fitted sequence exactly
    assert deg.max() == g["max_degree"] and deg.min() == 1
    assert (deg == 1).mean() > 0.1                        # many leaves, as the datasets


def test_graph_is_a_function_of_the_seed():
    a = chung_lu(3000, 9000, 90, 1, 77)
    assert np.array_equal(a, chung_lu(3000, 9000, 90, 1, 77))
    assert not np.array_equal(a, chung_lu(3000, 9000, 90, 1, 78))
    assert np.array_equal(chung_lu(500, 1400, 30, 1, -5), chung_lu(500, 1400, 30, 1, -5))


@pytest.mark.parametrize("name", ["youtube-r20", "skitter-r20"])
def test_config_files_state_the_graph_sizes(name):
    cfg = CONFIGS[name]
    g = cfg["graph"]
    entry = next(c for c in json.loads((ROOT / "BENCHMARK.json").read_text())["configs"]
                 if c["name"] == name)
    for k in ("n_vertices", "n_edges", "max_degree"):
        assert f"{g[k]:,}" in entry["source"] and f"{g[k]:,}" in cfg["source_detail"] + str(
            cfg["assumed"])
    edges, n = generate(scaled(g, 4000))
    assert n == 4000 and edges.shape[0] == scaled(g, 4000)["n_edges"]
    # the degree law the file states is the one the full-size fit gives
    n, m = g["n_vertices"], g["n_edges"]
    d = degree_sequence(n, m, g["max_degree"], g["min_degree"])
    _, a = chung_lu_weights(n, 2.0 * m, g["max_degree"], g["min_degree"])
    law = cfg["assumed"]["degree_law"]
    assert d.sum() == 2 * m and d[0] == g["max_degree"]
    assert f"= {1 + 1 / a:.3f})" in law and f"{100 * (d == 1).mean():.1f}% " in law
    assert str(d[:5].tolist()) in law and f"the 20th {d[19]:,}" in law


@pytest.fixture(scope="module")
def host_graph():
    g = scaled(CONFIGS["youtube-r20"]["graph"], 4000)
    return HostGraph(chung_lu(4000, g["n_edges"], g["max_degree"], 1, 5), 4000)


@pytest.mark.parametrize("name", ["uniform-batch", "local-batch"])
def test_batches_are_a_function_of_the_seed(host_graph, name):
    t = TRAFFIC[name]
    a = batch_pairs(t, host_graph, BIG_SEED, 3)
    b = batch_pairs(t, host_graph, BIG_SEED, 3)
    c = batch_pairs(t, host_graph, BIG_SEED, 4)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert a[0].shape == (t["batch"],) and a[0].dtype == np.int32


def test_walk_ends_within_its_steps(host_graph):
    t = TRAFFIC["local-batch"]
    us, vs = batch_pairs(t, host_graph, 9, 0)
    g = host_graph
    n = g.n
    rows = np.repeat(np.arange(n), np.diff(g.indptr))
    adj = coo_matrix((np.ones(rows.size), (rows, g.nbrs)), shape=(n, n)).tocsr()
    d = shortest_path(adj, unweighted=True, indices=us)[np.arange(us.size), vs]
    assert d.max() <= t["pairs"]["max_steps"]
    assert (d <= 1).mean() < 0.5                 # mostly friends of friends


def test_stream_is_a_function_of_the_seed(host_graph):
    t = TRAFFIC["hub-stream"]
    a = stream_schedule(t, host_graph, BIG_SEED, 5.0, rate=400)
    b = stream_schedule(t, host_graph, BIG_SEED, 5.0, rate=400)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert a["t"].size == 2000 and np.all(np.diff(a["t"]) >= 0)
    assert a["t"].min() >= 0 and a["t"].max() < 5.0
    # another seed: the same timeline and degrees, on other vertices
    c = stream_schedule(t, host_graph, BIG_SEED + 1, 5.0, rate=400)
    for k in ("t", "cls", "repeat", "burst"):
        assert np.array_equal(a[k], c[k])
    deg = host_graph.deg
    assert np.array_equal(deg[a["u"]], deg[c["u"]]) and np.array_equal(deg[a["v"]], deg[c["v"]])
    assert np.mean(a["u"] != c["u"]) > 0.3


def test_stream_matches_its_knobs(host_graph):
    t = TRAFFIC["hub-stream"]
    s = t["schedule"]
    n = 20000
    a = stream_schedule(t, host_graph, 4, n / 1000.0, rate=1000)
    assert a["t"].size == n
    assert (a["cls"] == 1).sum() == int(n * s["bulk_share"])
    assert np.array_equal(a["cls"] == 1, a["burst"] >= 0)
    sd = np.sqrt(s["repeat_p"] * (1 - s["repeat_p"]) / n)
    assert abs(a["repeat"].mean() - s["repeat_p"]) < 5 * sd
    lens = np.bincount(a["burst"][a["burst"] >= 0])
    lo, hi = s["burst_len"]
    assert lens[:-1].min() >= lo and lens.max() < hi     # the last one is cut
    assert abs(lens[:-1].mean() - (lo + hi - 1) / 2) < 5 * np.sqrt(
        ((hi - lo) ** 2 - 1) / 12 / (lens.size - 1))
    span = s["burst_span_us"] * 1e-6
    for j in range(5):
        tb = a["t"][a["burst"] == j]
        assert tb.max() - tb.min() <= span
    # endpoints lean to the hubs: rank x ** 3 puts half of them in the top 1/8
    rank = np.empty(host_graph.n, np.int64)
    rank[np.argsort(-host_graph.deg, kind="stable")] = np.arange(host_graph.n)
    fresh = ~a["repeat"]
    assert np.mean(rank[a["u"][fresh]] < host_graph.n / 8) > 0.45


def test_graph_cache_hits_and_misses(tmp_path, monkeypatch):
    spec = scaled(CONFIGS["youtube-r20"]["graph"], 3000)
    edges, n = graphgen.cached(spec, tmp_path)
    assert n == 3000 and np.array_equal(edges, generate(spec)[0])
    assert [p.suffix for p in tmp_path.iterdir()] == [".npy"]

    def drawn(_):
        raise AssertionError("a hit draws nothing")
    with monkeypatch.context() as m:
        m.setattr(graphgen, "generate", drawn)
        hit, n_hit = graphgen.cached(dict(spec), tmp_path)
    assert n_hit == n and hit.dtype == edges.dtype and np.array_equal(hit, edges)
    other, _ = graphgen.cached(dict(spec, seed=spec["seed"] + 1), tmp_path)
    assert len(list(tmp_path.iterdir())) == 2 and not np.array_equal(other, edges)
