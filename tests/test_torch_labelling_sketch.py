"""Port vs reference: offline labelling (Algorithm 2) and sketches (Eq. 3).

``build_labelling`` on the ``segment``, ``csr`` (blocked) and ``hybrid``
backends of both packages (the reference's hybrid engine runs its Pallas kernel in interpret
mode), then ``compute_sketch_batch`` on packed and unpacked rows (the
reference with ``use_pallas=True``, its min-plus kernel in interpret mode;
the port's ``ops.sketch_d_top`` takes the plain version on the CPU).
Every comparison is exact, with zero tolerance: all tables are int32 or
boolean.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import graph as jg  # noqa: E402
from repro.core import labelling as jl  # noqa: E402
from repro.core import packing as jp  # noqa: E402
from repro.core import sketch as jsk  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core import labelling as tl  # noqa: E402
from repro_torch.core import packing as tp  # noqa: E402
from repro_torch.core import sketch as tsk  # noqa: E402

CASES = {
    "gnp": (lambda m, **kw: m.gnp_random_graph(45, 3.2, seed=17, **kw), 5),
    "ba": (lambda m, **kw: m.barabasi_albert_graph(70, 2, seed=2, **kw), 6),
    "grid": (lambda m, **kw: m.grid_graph(6, 7, **kw), 4),
    "split": (lambda m, **kw: m.from_edges(
        np.array([(0, 1), (1, 2), (2, 3), (3, 0), (5, 6), (6, 7), (7, 8), (8, 5),
                  (6, 8)]), 10, **kw), 3),
}
SCHEME_FIELDS = ("landmarks", "lid", "is_landmark", "label_dist", "meta_w",
                 "meta_dist")


@pytest.fixture(scope="module")
def schemes():
    out = {}
    for name, (gen, nl) in CASES.items():
        gj, gt = gen(jg), gen(tg, device="cpu")
        lms = jg.select_landmarks(gj, nl)
        out[name] = (gj, gt, lms, jl.build_labelling(gj, lms))
    return out


@pytest.mark.parametrize("backend", ["segment", "csr", "hybrid"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_build_labelling_bit_identical(schemes, name, backend):
    gj, gt, lms, sj = schemes[name]
    kw = {"n_hubs": 8} if backend == "hybrid" else {}
    if backend == "hybrid":
        sj = jl.build_labelling(gj, lms, backend="hybrid", use_pallas=True,
                                interpret=True, **kw)
    if backend == "csr":
        kw = {"block_size": 50}
        sj = jl.build_labelling(gj, lms, backend="csr", **kw)
    st = tl.build_labelling(gt, lms, backend=backend, device="cpu", **kw)
    for f in SCHEME_FIELDS:
        a, b = np.asarray(getattr(sj, f)), getattr(st, f).numpy()
        assert a.dtype == b.dtype, f
        assert np.array_equal(a, b), f
    assert st.n_landmarks == sj.n_landmarks


@pytest.mark.parametrize("name", sorted(CASES))
def test_labelling_size_bytes_matches_reference(schemes, name):
    gj, gt, lms, sj = schemes[name]
    st = tl.build_labelling(gt, lms, device="cpu")
    assert tl.labelling_size_bytes(st) == jl.labelling_size_bytes(sj)


def test_meta_apsp_matches_reference():
    rng = np.random.default_rng(0)
    w = rng.integers(1, 9, size=(9, 9)).astype(np.int32)
    w = np.where(rng.random(w.shape) < 0.6, jg.INF, w)
    w = np.minimum(w, w.T)
    np.fill_diagonal(w, jg.INF)
    want = np.asarray(jl.meta_apsp(jnp.asarray(w)))
    assert np.array_equal(tl.meta_apsp(torch.from_numpy(w)).numpy(), want)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_compute_sketch_batch_matches_reference(schemes, name, packed):
    gj, gt, lms, sj = schemes[name]
    st = tl.build_labelling(gt, lms, device="cpu")
    rng = np.random.default_rng(5)
    us = rng.integers(0, gj.n_vertices, size=12)
    vs = rng.integers(0, gj.n_vertices, size=12)
    if packed:
        pj, pt = jp.pack_labelling(sj), tp.pack_labelling(st)
        tabs_j = (pj.label_dist, pj.meta_w, pj.meta_dist)
        tabs_t = (pt.label_dist, pt.meta_w, pt.meta_dist)
    else:
        tabs_j = (sj.label_dist, sj.meta_w, sj.meta_dist)
        tabs_t = (st.label_dist, st.meta_w, st.meta_dist)
    want = jsk.compute_sketch_batch(
        tabs_j[0][jnp.asarray(us)], tabs_j[0][jnp.asarray(vs)], tabs_j[1],
        tabs_j[2], use_pallas=True)
    got = tsk.compute_sketch_batch(
        tabs_t[0][torch.from_numpy(us)], tabs_t[0][torch.from_numpy(vs)],
        tabs_t[1], tabs_t[2])
    for f in want._fields:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype, f
        assert np.array_equal(a, b), f
    d = tsk.d_top_only(tabs_t[0][torch.from_numpy(us)],
                       tabs_t[0][torch.from_numpy(vs)], tabs_t[2])
    dj = jsk.d_top_only(tabs_j[0][jnp.asarray(us)], tabs_j[0][jnp.asarray(vs)],
                        tabs_j[2])
    assert np.array_equal(d.numpy(), np.asarray(dj))
