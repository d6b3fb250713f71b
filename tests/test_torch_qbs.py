"""Port vs reference: the slice as a whole, ``QbSIndex.build`` ->
``query_batch`` / ``query_batch_arrays``.

Each graph is built by both packages from the same seed; the port answers
on the ``segment``, ``csr`` and ``hybrid`` backends (its kernels' plain versions on
the CPU) and is held against ``repro.core.QbSIndex`` (on one graph with the
hybrid engine's Pallas kernel in interpret mode) and against the numpy
serving oracle in ``tests/helpers/serving_oracle.py``.  The batches cover
every lane (general, landmark pair, one-sided, trivial), duplicates,
reversed pairs and ragged chunk tails; the graphs include many tied paths
(a grid), two components, and a 300-vertex path whose labels promote to
uint16.  ``convert.index_from_numpy`` serves on the reference's own
labelling.  Every comparison is exact, with zero tolerance: distances are
int32 and SPGs boolean edge masks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers.serving_oracle import assert_bit_identical  # noqa: E402

from repro.core import QbSIndex as JIndex  # noqa: E402
from repro.core import graph as jg  # noqa: E402
from repro.core.labelling import build_labelling as j_build_labelling  # noqa: E402
from repro_torch.convert import graph_from_numpy, index_from_numpy  # noqa: E402
from repro_torch.core import QbSIndex as TIndex  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core.labelling import build_labelling as t_build_labelling  # noqa: E402

SPLIT_EDGES = np.concatenate([
    np.random.default_rng(9).integers(0, 30, size=(50, 2)),
    np.random.default_rng(10).integers(30, 60, size=(50, 2))])

CASES = {
    "gnp": (lambda m, **kw: m.gnp_random_graph(45, 3.2, seed=17, **kw), 5),
    "grid": (lambda m, **kw: m.grid_graph(6, 7, **kw), 4),
    "split": (lambda m, **kw: m.from_edges(SPLIT_EDGES, 60, **kw), 4),
}
HYBRID = {"n_hubs": 16}
CSR = {"block_size": 100}
ENGINE_OPTS = {"segment": None, "csr": CSR, "hybrid": HYBRID}
SCHEME_FIELDS = ("landmarks", "lid", "is_landmark", "label_dist", "meta_w",
                 "meta_dist")


def _queries(idx, n_vertices, seed):
    """A ragged batch over every lane, with duplicates and reversed pairs."""
    rng = np.random.default_rng(seed)
    lms = np.asarray(idx.scheme.landmarks)
    non = np.flatnonzero(~np.asarray(idx.scheme.is_landmark))
    us = list(rng.integers(0, n_vertices, 20))
    vs = list(rng.integers(0, n_vertices, 20))
    us += [lms[0], lms[1], lms[2], lms[0], non[0], lms[1], non[3], non[4], lms[2]]
    vs += [lms[1], lms[2], non[1], non[2], lms[3], non[5], non[3], non[6], lms[2]]
    us += [vs[0], us[1]]          # reversed and duplicated general pairs
    vs += [us[0], vs[1]]
    return np.asarray(us, np.int32), np.asarray(vs, np.int32)


@pytest.fixture(scope="module")
def reference():
    out = {}
    for name, (gen, nl) in CASES.items():
        gj = gen(jg)
        idx = JIndex.build(gj, n_landmarks=nl, chunk=8)
        us, vs = _queries(idx, gj.n_vertices, seed=len(name))
        out[name] = (gj, idx, us, vs, idx.query_batch_arrays(us, vs))
    return out


def _port_index(name, backend):
    gen, nl = CASES[name]
    return TIndex.build(gen(tg, device="cpu"), n_landmarks=nl, chunk=8,
                        backend=backend, engine_opts=ENGINE_OPTS[backend],
                        device="cpu")


def _same_scheme(sj, st):
    for f in SCHEME_FIELDS:
        assert np.array_equal(np.asarray(getattr(sj, f)), getattr(st, f).numpy()), f


@pytest.mark.parametrize("backend", ["segment", "csr", "hybrid"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_query_batch_matches_reference_and_oracle(reference, name, backend):
    gj, idx_j, us, vs, (d_j, m_j) = reference[name]
    idx = _port_index(name, backend)
    _same_scheme(idx_j.scheme, idx.scheme)
    for a, b in zip(idx_j.packed, idx.packed):
        assert np.array_equal(np.asarray(a), b.numpy())
    d, m = idx.query_batch_arrays(us, vs)
    assert d.dtype == np.int32 and m.dtype == bool
    assert np.array_equal(d, np.asarray(d_j))
    assert np.array_equal(m, np.asarray(m_j))
    res = idx.query_batch(us, vs)
    assert_bit_identical(gj, res, us, vs)
    for r, rj in zip(res, idx_j.query_batch(us, vs)):
        assert r.d_top == rj.d_top
        assert r.edge_pairs(idx.graph) == rj.edge_pairs(gj)
        assert r.vertices(idx.graph) == rj.vertices(gj)


def test_hybrid_matches_reference_with_pallas_interpret(reference):
    gj, _, us, vs, _ = reference["gnp"]
    idx_j = JIndex.build(gj, n_landmarks=5, chunk=8, backend="hybrid",
                         engine_opts={**HYBRID, "use_pallas": True,
                                      "interpret": True})
    d_j, m_j = idx_j.query_batch_arrays(us, vs)
    idx = _port_index("gnp", "hybrid")
    d, m = idx.query_batch_arrays(us, vs)
    assert np.array_equal(d, np.asarray(d_j))
    assert np.array_equal(m, np.asarray(m_j))


def test_csr_matches_reference_csr_engine(reference):
    """The reference's own ``csr`` index (blocked) against the port's."""
    gj, _, us, vs, _ = reference["split"]
    idx_j = JIndex.build(gj, n_landmarks=4, chunk=8, backend="csr",
                         engine_opts=CSR)
    d_j, m_j = idx_j.query_batch_arrays(us, vs)
    idx = _port_index("split", "csr")
    assert idx.ctx.engine.backend == "csr" and idx.ctx.engine.block_size == 100
    _same_scheme(idx_j.scheme, idx.scheme)
    d, m = idx.query_batch_arrays(us, vs)
    assert np.array_equal(d, np.asarray(d_j))
    assert np.array_equal(m, np.asarray(m_j))


@pytest.mark.parametrize("backend", ["segment", "hybrid"])
def test_convert_serves_on_the_reference_labelling(reference, backend):
    gj, idx_j, us, vs, (d_j, m_j) = reference["gnp"]
    idx = index_from_numpy([np.asarray(a) for a in gj],
                           {f: np.asarray(getattr(idx_j.scheme, f))
                            for f in SCHEME_FIELDS},
                           device="cpu", backend=backend,
                           n_hubs=16 if backend == "hybrid" else None, chunk=8)
    d, m = idx.query_batch_arrays(us, vs)
    assert np.array_equal(d, np.asarray(d_j))
    assert np.array_equal(m, np.asarray(m_j))
    # the port's own build gives the same labelling
    _same_scheme(idx_j.scheme, _port_index("gnp", backend).scheme)
    g = graph_from_numpy(*[np.asarray(a) for a in gj], device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(g, idx.graph))


@pytest.mark.parametrize("backend", ["segment", "csr", "hybrid"])
def test_high_diameter_path_promotes_to_uint16(backend):
    gj = jg.grid_graph(1, 300)
    gt = tg.grid_graph(1, 300, device="cpu")
    lms = np.array([0, 299], np.int32)
    sj = j_build_labelling(gj, lms, max_levels=400)
    st = t_build_labelling(gt, lms, max_levels=400, device="cpu")
    _same_scheme(sj, st)
    idx = TIndex(gt, st, chunk=8, backend=backend,
                 engine_opts=ENGINE_OPTS[backend])
    assert idx.packed.dtype == np.uint16
    assert idx.packed.label_dist.dtype == torch.uint16
    us = np.array([0, 10, 150, 299, 42, 7], np.int32)
    vs = np.array([299, 290, 150, 0, 257, 298], np.int32)
    assert_bit_identical(gj, idx.query_batch(us, vs), us, vs)


@pytest.mark.parametrize("pad", [False, True])
def test_reverse_edge_map_matches_reference(pad):
    from repro.core.qbs import _reverse_edge_map as j_rev
    from repro_torch.core.qbs import _reverse_edge_map as t_rev

    kw = dict(pad_vertices_to=50, pad_edges_to=200) if pad else {}
    gj = jg.gnp_random_graph(45, 3.2, seed=17, **kw)
    gt = tg.gnp_random_graph(45, 3.2, seed=17, device="cpu", **kw)
    want = j_rev(np.asarray(gj.src), np.asarray(gj.dst), gj.n_vertices)
    got = t_rev(gt.src, gt.dst, gt.n_vertices)
    assert np.array_equal(got.numpy(), want)


def test_service_options_do_not_change_answers(reference):
    gj, _, us, vs, (d_j, m_j) = reference["grid"]
    idx = _port_index("grid", "segment")
    for kw in ({"async_depth": 1}, {"async_depth": 3, "chunk": 5}):
        d, m = idx.make_service(**kw).query_arrays(us, vs)
        assert np.array_equal(d, np.asarray(d_j))
        assert np.array_equal(m, np.asarray(m_j))
    r = idx.query(int(us[0]), int(vs[0]))
    assert r.dist == int(d_j[0])
    assert np.array_equal(r.edge_ids, np.flatnonzero(np.asarray(m_j[0])))
