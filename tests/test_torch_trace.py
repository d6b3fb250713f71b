"""The port's tracer (``repro_torch.trace``) on the CPU.

Off (no profiler recording): a span is one shared no-op context that opens
no ``record_function``, reads no clock and creates no CUDA event, and no
counter moves.  Under ``torch.profiler.profile``: the spans nest as the
general lane's stages (``serve_step`` over ``sketch``, ``search.bfs``,
``search.reverse``, ``search.attach``, ``search.delta`` and
``symmetrize``), each carrying its ``serve_step``'s chunk id; the level
and closure counters equal hand counts on graphs whose distances are
known; and the answers are bit-identical with the profiler on and off.
Each test starts from ``trace.reset()``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import trace  # noqa: E402
from repro_torch.core import QbSIndex, from_edges, gnp_random_graph, grid_graph  # noqa: E402

STAGES = {"sketch", "search.bfs", "search.reverse", "search.attach",
          "search.delta", "symmetrize"}


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _pairs(pairs):
    us, vs = zip(*pairs)
    return (torch.tensor(us, dtype=torch.int32), torch.tensor(vs, dtype=torch.int32))


@pytest.fixture(scope="module")
def gnp_index():
    g = gnp_random_graph(300, 3.0, seed=2, device="cpu")
    return QbSIndex.build(g, n_landmarks=6, backend="hybrid", device="cpu")


def _gnp_pairs():
    rng = np.random.default_rng(7)
    return rng.integers(0, 300, 80), rng.integers(0, 300, 80)


def test_off_records_nothing(gnp_index, monkeypatch):
    trace.reset()

    def refuse(*a, **kw):
        raise AssertionError("the tracer acted with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(trace.time, "perf_counter_ns", refuse)
    assert not torch.autograd._profiler_enabled()
    assert trace.span("x") is trace.span("y", torch.device("cuda"), chunk=True)
    with trace.span("search.bfs", torch.device("cuda")):
        trace.count("search.bfs_levels", 3)
    gnp_index.query_batch_arrays(*_gnp_pairs())
    assert trace.report() == {"spans": {}, "counters": {}, "records": []}


def test_answers_bit_identical_with_the_profiler_on(gnp_index):
    trace.reset()
    us, vs = _gnp_pairs()
    d_off, m_off = gnp_index.query_batch_arrays(us, vs)
    (d_on, m_on), _ = _profiled(lambda: gnp_index.query_batch_arrays(us, vs))
    assert np.array_equal(d_off, d_on) and np.array_equal(m_off, m_on)
    assert trace.report()["spans"]["serve_step"]["calls"] == 3   # 80 pairs, chunk 32


def test_span_tree_and_chunk_ids(gnp_index):
    trace.reset()
    us, vs = _gnp_pairs()
    _, prof = _profiled(lambda: gnp_index.query_batch_arrays(us, vs))
    r = trace.report()
    recs = {x["id"]: x for x in r["records"]}
    steps = [x for x in recs.values() if x["name"] == "serve_step"]
    assert len(steps) == 3 and all(x["parent"] is None for x in steps)
    assert len({x["chunk"] for x in steps}) == 3 and None not in {x["chunk"] for x in steps}
    for step in steps:
        kids = [x for x in recs.values() if x["parent"] == step["id"]]
        names = [x["name"] for x in kids]
        assert set(names) == STAGES
        assert names.count("search.attach") == 2
        assert all(x["chunk"] == step["chunk"] for x in kids)
        assert not any(x["parent"] == k["id"] for k in kids for x in recs.values())
        assert step["counts"]["search.rows"] == 32
        by = {x["name"]: x for x in kids}
        assert by["search.bfs"]["counts"]["search.bfs_levels"] >= 1
        attach = [x for x in kids if x["name"] == "search.attach"]
        assert all(x["counts"]["search.closure_steps"] >= 1 for x in attach)
    drains = [x for x in recs.values() if x["name"] == "drain"]
    assert drains and all(x["parent"] is None and x["chunk"] is None for x in drains)
    assert all(x["device_ms"] is None for x in recs.values())    # CPU tensors
    assert all(s["device_ms"] is None and s["host_ms"] > 0 for s in r["spans"].values())
    counters = r["counters"]
    assert counters["search.rows"] == 96
    assert 0 <= counters["search.recover_rows"] <= 96
    assert counters["search.host_syncs"] > counters["search.bfs_levels"]
    # every span is also a profiler range with the program's prefix
    names = {e.name for e in prof.events() if e.name.startswith(trace.PREFIX)}
    assert names == {trace.PREFIX + n for n in STAGES | {"serve_step", "drain"}}


def _path_index(n, **kw):
    g = from_edges(np.array([[i, i + 1] for i in range(n - 1)]), n, device="cpu")
    return QbSIndex.build(g, landmarks=np.array([1]), device="cpu", **kw)


# Levels of the bidirectional BFS on G-: each pass of its loop grows one
# side of every active row by one hop, and a row stops once its two balls
# share a vertex, i.e. after d(u, v) passes when both endpoints are beyond
# the one landmark (the sketch's bound through it is longer), so a chunk
# runs max d(u, v) levels.
LEVEL_CASES = {
    # path 0-1-...-39, landmark 1: d = v - u
    "path": (lambda: _path_index(40), [(5, 9), (10, 20), (22, 25)], 10),
    # 8 x 8 grid, landmark the corner 0: d = Manhattan distance
    "grid": (lambda: QbSIndex.build(grid_graph(8, 8, device="cpu"),
                                    landmarks=np.array([0]), device="cpu"),
             [(2 * 8 + 5, 5 * 8 + 2), (3 * 8 + 3, 4 * 8 + 4), (7 * 8 + 7, 7 * 8 + 1)], 6),
}


@pytest.mark.parametrize("case", sorted(LEVEL_CASES))
def test_bfs_levels_equal_hand_count(case):
    trace.reset()
    make, pairs, levels = LEVEL_CASES[case]
    idx = make()
    (dist, _), _ = _profiled(lambda: idx.serve_step(*_pairs(pairs)))
    n = 8 if case == "grid" else None
    want = [abs(u - v) if n is None else abs(u // n - v // n) + abs(u % n - v % n)
            for u, v in pairs]
    assert dist.tolist() == want and max(want) == levels
    c = trace.report()["counters"]
    assert c["search.bfs_levels"] == levels
    assert c["search.rows"] == len(pairs) and c["search.recover_rows"] == 0
    assert "search.closure_steps" not in c


def test_closure_steps_equal_hand_count():
    """Path 0-1-...-29, landmark 1, the pair (0, 20) with ``max_levels=6``.
    Vertex 0's one edge leads to the landmark, so G- gives it no neighbour
    and d_G- = INF; the sketch's bound through the landmark, 1 + 19 = 20, is
    the distance, and the row goes to the recover search.  The BFS runs its
    6 levels (the cap) on the side of 20, whose ball reaches 14.  The v
    side's closure then certifies 13, 12, ..., 2 along the label-decrement
    edges of G-, one vertex per step (12 steps), and one more step finds no
    change: 13.  The u side's chain {0} has no edge in G-: one step.  14 in
    all."""
    trace.reset()
    idx = _path_index(30, max_levels=6)
    (dist, mask), _ = _profiled(lambda: idx.serve_step(*_pairs([(0, 20)])))
    assert dist.tolist() == [20]
    src, dst = idx.graph.src.numpy(), idx.graph.dst.numpy()
    on = {(int(min(a, b)), int(max(a, b))) for a, b in zip(src[mask[0].numpy()],
                                                          dst[mask[0].numpy()])}
    assert on == {(i, i + 1) for i in range(20)}
    c = trace.report()["counters"]
    assert c["search.bfs_levels"] == 6
    assert c["search.closure_steps"] == 14
    assert c["search.recover_rows"] == c["search.rows"] == 1
    attach = [x for x in trace.report()["records"] if x["name"] == "search.attach"]
    assert [x["counts"]["search.closure_steps"] for x in attach] == [1, 13]


def test_reset_and_nested_counts():
    trace.reset()

    def work():
        with trace.span("outer", chunk=True):
            trace.count("a", 2)
            with trace.span("inner"):
                trace.count("a")
                trace.count("b", 5)
        with trace.span("outer", chunk=True):
            pass

    _profiled(work)
    r = trace.report()
    assert r["counters"] == {"a": 3, "b": 5}
    outer, inner, outer2 = r["records"]
    assert outer["counts"] == {"a": 2} and inner["counts"] == {"a": 1, "b": 5}
    assert inner["parent"] == outer["id"] and inner["chunk"] == outer["chunk"]
    assert outer2["chunk"] != outer["chunk"]
    assert r["spans"]["outer"]["calls"] == 2
    trace.reset()
    assert trace.report() == {"spans": {}, "counters": {}, "records": []}
