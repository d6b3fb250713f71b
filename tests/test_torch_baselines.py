"""Port vs reference: the baselines, the host helpers and the serving CLI.

``bfs_distances``, ``bfs_spg`` and ``bibfs_spg_batch`` / ``bibfs_spg`` on
the ``segment``, ``csr`` and ``hybrid`` engines, ``PPLIndex`` with and
without parents (labels, parent sets, ``query``, ``memory_bytes``),
``largest_connected_component``, and ``repro_torch.launch.serve.main`` on
the CPU against ``repro.launch.serve.main``.  Both packages build every
graph from the same seed.  Every comparison is exact, with zero tolerance:
distances are int32 and SPGs sets of edge-slot ids (int64 on both sides).
"""
import re
import sys

import numpy as np
import pytest

from repro.core import baselines as jb
from repro.core import graph as jg
from repro_torch.core import QbSIndex
from repro_torch.core import baselines as tb
from repro_torch.core import graph as tg

BACKENDS = ("segment", "csr", "hybrid")

SPLIT_EDGES = np.concatenate([
    np.random.default_rng(9).integers(0, 25, size=(45, 2)),
    np.random.default_rng(10).integers(25, 50, size=(45, 2))])


GRAPHS = {
    "ba": lambda m, **kw: m.barabasi_albert_graph(60, 2, seed=3, **kw),
    "split": lambda m, **kw: m.from_edges(SPLIT_EDGES, 50, **kw),
}
PAIRS = [(0, 17), (5, 5), (3, 41), (12, 30), (49, 1), (7, 26)]


@pytest.fixture(scope="module")
def graphs():
    return {k: (g(jg), g(tg, device="cpu")) for k, g in GRAPHS.items()}


def _same_result(a, b):
    assert (a.u, a.v, a.dist, a.d_top) == (b.u, b.v, b.dist, b.d_top)
    assert a.edge_ids.dtype == b.edge_ids.dtype == np.int64
    assert np.array_equal(a.edge_ids, b.edge_ids)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_bfs_spg_matches_reference(graphs, name, backend):
    gj, gt = graphs[name]
    for u, v in PAIRS:
        want = jb.bfs_spg(gj, u, v)
        _same_result(want, tb.bfs_spg(gt, u, v, backend=backend, device="cpu"))
    d = tb.bfs_distances(gt, 4, backend=backend, device="cpu")
    assert d.dtype == np.int32
    assert np.array_equal(d, jb.bfs_distances(gj, 4))


@pytest.mark.parametrize("backend", BACKENDS)
def test_bibfs_spg_batch_matches_reference(graphs, backend):
    gj, gt = graphs["split"]
    us = np.array([p[0] for p in PAIRS] + [20, 33], np.int32)
    vs = np.array([p[1] for p in PAIRS] + [20, 2], np.int32)
    want = jb.bibfs_spg_batch(gj, us, vs, backend=backend)
    got = tb.bibfs_spg_batch(gt, us, vs, backend=backend, device="cpu")
    assert len(got) == len(want) == us.size
    for a, b in zip(want, got):
        _same_result(a, b)
        _same_result(jb.bfs_spg(gj, a.u, a.v), b)     # Bi-BFS is exact
    _same_result(want[2], tb.bibfs_spg(gt, int(us[2]), int(vs[2]),
                                       backend=backend, device="cpu"))


@pytest.mark.parametrize("store_parents", [False, True])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_ppl_matches_reference(graphs, name, store_parents):
    """Labels, parents, distances and sizes equal the reference's bit for
    bit; each answer is the exact SPG and holds every edge the reference's
    answer holds (equal wherever the reference's is exact)."""
    gj, gt = graphs[name]
    pj = jb.PPLIndex(gj, store_parents=store_parents)
    pt = tb.PPLIndex(gt, store_parents=store_parents)
    assert np.array_equal(pt.order, pj.order)
    assert pt.lab.dtype == pj.lab.dtype and np.array_equal(pt.lab, pj.lab)
    assert pt.parents == pj.parents
    assert np.array_equal(pt.vertex_to_rank, pj.vertex_to_rank)
    assert pt.label_entries() == pj.label_entries()
    assert pt.memory_bytes() == pj.memory_bytes()
    for u, v in PAIRS:
        assert pt.dist(u, v) == pj.dist(u, v)
        got, ref, exact = pt.query(u, v), pj.query(u, v), jb.bfs_spg(gj, u, v)
        _same_result(exact, got)
        assert set(ref.edge_ids) <= set(got.edge_ids)
        if set(ref.edge_ids) == set(exact.edge_ids):
            _same_result(ref, got)


def test_ppl_query_completes_the_reference():
    """The reference's PPL answer misses edges where no common hub covers a
    shortest path; the port's is exact there (ROADMAP queue 3)."""
    gj = jg.barabasi_albert_graph(1000, 3, seed=0)
    gt = tg.barabasi_albert_graph(1000, 3, seed=0, device="cpu")
    ref = jb.PPLIndex(gj).query(298, 849)
    got = tb.PPLIndex(gt).query(298, 849)
    exact = jb.bfs_spg(gj, 298, 849)
    assert ref.dist == got.dist == exact.dist == 5
    assert (ref.edge_ids.size, got.edge_ids.size) == (48, 50)
    _same_result(exact, got)


def test_ppl_agrees_with_qbs(graphs):
    """PPL and a QbS index of the same graph give the same SPGs."""
    _, gt = graphs["ba"]
    ppl = tb.PPLIndex(gt, store_parents=True)
    idx = QbSIndex.build(gt, n_landmarks=5, chunk=8, device="cpu")
    us = np.array([p[0] for p in PAIRS], np.int32)
    vs = np.array([p[1] for p in PAIRS], np.int32)
    for r in idx.query_batch(us, vs):
        p = ppl.query(r.u, r.v)
        assert p.dist == r.dist
        assert np.array_equal(p.edge_ids, r.edge_ids)


@pytest.mark.parametrize("n_comp", [1, 3])
def test_largest_connected_component_matches_reference(n_comp):
    rng = np.random.default_rng(n_comp)
    blocks = [rng.integers(0, 20, size=(25 + 10 * i, 2)) + 20 * i
              for i in range(n_comp)]
    edges = np.concatenate(blocks)
    n = 20 * n_comp + 4                      # 4 isolated vertices at the end
    want_e, want_n = jg.largest_connected_component(edges, n)
    got_e, got_n = tg.largest_connected_component(edges, n)
    assert got_n == want_n
    assert got_e.dtype == want_e.dtype and np.array_equal(got_e, want_e)


_TIMES = re.compile(r"\d+\.\d+s|\(\d+\.\d+ ms/query")


@pytest.mark.parametrize("graph", ["ba", "cliques"])
def test_serve_cli_matches_reference(graph, capsys, monkeypatch):
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve

    args = ["--graph", graph, "--n", "240", "--landmarks", "6",
            "--queries", "24", "--chunk", "8", "--seed", "3"]
    monkeypatch.setattr(sys, "argv", ["serve"] + args)
    jserve.main()
    want = capsys.readouterr().out.splitlines()
    outs = []
    for backend in BACKENDS:
        tserve.main(args + ["--backend", backend, "--device", "cpu"])
        outs.append(capsys.readouterr().out.splitlines())
    for got in outs:
        assert len(got) == len(want) == 5
        assert [_TIMES.sub("T", x) for x in got] == [_TIMES.sub("T", x) for x in want]


@pytest.mark.parametrize("flag", [["--shards", "2"], ["--replicas", "2"],
                                  ["--metrics-port", "0"]])
def test_serve_cli_refuses_unported_modes(flag, capsys):
    """``--shards`` (the multi-GPU index) is not ported and exits with a
    message; ``--replicas`` and ``--metrics-port`` are ported and serve
    through a ``ReplicaRouter``."""
    from repro_torch.launch import serve as tserve

    argv = ["--n", "50", "--queries", "8", "--device", "cpu"] + flag
    if flag[0] == "--shards":
        with pytest.raises(SystemExit) as e:
            tserve.main(argv)
        assert e.value.code != 0
        assert "not ported" in capsys.readouterr().err
    else:
        tserve.main(argv)
        out = capsys.readouterr().out
        assert "[serve] router: 8 routed" in out
        assert ("[serve] metrics: http://127.0.0.1:" in out) == \
            (flag[0] == "--metrics-port")
