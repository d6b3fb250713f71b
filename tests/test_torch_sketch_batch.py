"""Port vs reference: the fused sketch (``kernels.ops.sketch_batch``).

``ref.sketch_batch_ref`` (the plain version the CPU runs) and
``core.sketch.compute_sketch_batch`` are held to the reference's
``repro.core.sketch.compute_sketch_batch`` with ``use_pallas=True`` (its
min-plus kernel in interpret mode) and with ``use_pallas=False``, on all six
fields, with zero tolerance and the same dtypes: the sketch is integer and
boolean.  Tables come packed (uint8, uint16) and as int32, with R from 1 to
33 and batches of 1 to 32; the graphs include landmarks in two components
(INF meta entries, all-INF rows) and a 300-vertex path whose tables promote
to uint16.

``kernel_model`` is a numpy model of the CUDA kernel's schedule
(``csrc/sketch_batch.cu``): the block minimum, the attaining-pair bitmap
with its row and column masks, the meta-edge test walking set bits, and the
budgets.  It is held to the reference here; the kernel itself is held to
the plain version on the card (``tests/test_torch_kernels_cuda.py``).
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
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.sketch import smem_layout  # noqa: E402

INF = jg.INF
DTYPES = {"uint8": np.uint8, "uint16": np.uint16, "int32": np.int32}
FIELDS = jsk.SketchBatch._fields


def _meta_tables(rng, r, kind, scale):
    """int32 (meta_w, meta_dist): a random meta graph with weights up to
    3 * scale and its APSP, the same with the landmarks in two components,
    or arbitrary asymmetric tables (the sketch's arithmetic must match on
    any input)."""
    if kind == "asymmetric":
        w = rng.integers(1, 3 * scale + 1, size=(r, r))
        d = rng.integers(0, 3 * scale + 1, size=(r, r))
        w = np.where(rng.random((r, r)) < 0.3, INF, w)
        d = np.where(rng.random((r, r)) < 0.15, INF, d)
        return w.astype(np.int32), d.astype(np.int32)
    w = rng.integers(1, 4, size=(r, r)) * scale
    w = np.where(rng.random((r, r)) < 0.5, w, INF)
    if kind == "two_components":
        side = np.arange(r) < (r + 1) // 2
        w = np.where(side[:, None] == side[None, :], w, INF)
    w = np.minimum(w, w.T)
    np.fill_diagonal(w, INF)
    d = np.minimum(w, INF)
    np.fill_diagonal(d, 0)
    for k in range(r):
        d = np.minimum(d, d[:, k:k + 1] + d[k:k + 1, :])
    return w.astype(np.int32), np.minimum(d, INF).astype(np.int32)


def _rows(rng, b, r, hi):
    x = rng.integers(0, hi, size=(b, r))
    x = np.where(rng.random((b, r)) < 0.2, INF, x)
    x[rng.random(b) < 0.1] = INF                 # some all-INF rows
    return x.astype(np.int32)


def _pack(x, dtype):
    if dtype == np.int32:
        return x
    assert not ((x >= np.iinfo(dtype).max) & (x < INF)).any()
    return np.where(x >= INF, np.iinfo(dtype).max, x).astype(dtype)


def _reference(tabs, use_pallas):
    return jsk.compute_sketch_batch(*(jnp.asarray(t) for t in tabs),
                                    use_pallas=use_pallas)


def _assert_same(want, got, what):
    for f, g in zip(FIELDS, got):
        a = np.asarray(getattr(want, f))
        b = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert a.dtype == b.dtype, (what, f)
        assert a.shape == b.shape, (what, f)
        assert np.array_equal(a, b), (what, f)


def _widen(x):
    x = np.asarray(x)
    if x.dtype in (np.uint8, np.uint16):
        return np.where(x == np.iinfo(x.dtype).max, INF, x.astype(np.int32))
    return x.astype(np.int32)


def kernel_model(lu, lv, meta_w, meta_dist):
    """The kernel's schedule in numpy, one block (query) at a time."""
    lu, lv, mw, md = (_widen(t) for t in (lu, lv, meta_w, meta_dist))
    b_n, r_n = lu.shape
    nw = (r_n + 31) // 32
    out = (np.zeros(b_n, np.int32), np.zeros((b_n, r_n), np.int32),
           np.zeros((b_n, r_n), np.int32), np.zeros((b_n, r_n, r_n), bool),
           np.zeros(b_n, np.int32), np.zeros(b_n, np.int32))

    def bit(words, x):
        return (int(words[x >> 5]) >> (x & 31)) & 1

    def set_bits(words):
        for wi, word in enumerate(words):
            word = int(word)
            while word:
                low = word & -word
                yield wi * 32 + low.bit_length() - 1
                word &= word - 1

    for b in range(b_n):
        pi = np.minimum(lu[b, :, None] + md + lv[b, None, :], INF)   # viaddmin
        dtop = int(pi.min())                      # the block minimum
        att = np.zeros((r_n, nw), np.uint32)
        row_bits = np.zeros(nw, np.uint32)
        col_bits = np.zeros(nw, np.uint32)
        if dtop < INF:
            for r, s in zip(*np.nonzero(pi == dtop)):
                att[r, s >> 5] |= np.uint32(1 << (s & 31))
                row_bits[r >> 5] |= np.uint32(1 << (r & 31))
                col_bits[s >> 5] |= np.uint32(1 << (s & 31))
        out[0][b] = dtop
        for side, x, present, budget in ((1, lu, row_bits, 4), (2, lv, col_bits, 5)):
            land = [x[b, r] if bit(present, r) else INF for r in range(r_n)]
            out[side][b] = land
            out[budget][b] = max(max(v - 1 if v < INF else -1 for v in land), 0)
        for i in range(r_n):
            for j in range(r_n):
                w = mw[i, j]
                on = False
                if w < INF:
                    for r in set_bits(row_bits):
                        left = md[r, i] + w
                        if any(left + md[s, j] == md[r, s] for s in set_bits(att[r])):
                            on = True
                            break
                out[3][b, i, j] = on
    return out


@pytest.mark.parametrize("b", [1, 7, 32])
@pytest.mark.parametrize("r", [1, 2, 5, 20, 33])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_sketch_batch_matches_reference(dtype, r, b):
    rng = np.random.default_rng(1000 * r + 10 * b + len(dtype))
    dt = DTYPES[dtype]
    hi, scale = (400, 50) if dt == np.uint16 else (40, 2)
    meta_w, meta_dist = _meta_tables(rng, r, "apsp", scale)
    tabs = tuple(_pack(t, dt) for t in (_rows(rng, b, r, hi), _rows(rng, b, r, hi),
                                        meta_w, meta_dist))
    want = _reference(tabs, use_pallas=True)
    _assert_same(want, _reference(tabs, use_pallas=False), "reference paths")
    tt = tuple(torch.from_numpy(t) for t in tabs)
    _assert_same(want, ref.sketch_batch_ref(*tt), "sketch_batch_ref")
    _assert_same(want, tsk.compute_sketch_batch(*tt), "compute_sketch_batch")
    if b <= 7:
        _assert_same(want, kernel_model(*tabs), "kernel_model")


@pytest.mark.parametrize("kind", ["apsp", "two_components", "asymmetric"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_sketch_batch_table_kinds(dtype, kind):
    """Tables with unreachable landmark pairs and arbitrary tables; the
    kernel model follows the reference on each."""
    rng = np.random.default_rng(len(kind) * 7 + len(dtype))
    dt = DTYPES[dtype]
    r, b = 9, 12
    meta_w, meta_dist = _meta_tables(rng, r, kind, 5 if dt == np.uint8 else 60)
    tabs = tuple(_pack(t, dt) for t in (_rows(rng, b, r, 30), _rows(rng, b, r, 30),
                                        meta_w, meta_dist))
    want = _reference(tabs, use_pallas=True)
    _assert_same(want, _reference(tabs, use_pallas=False), "reference paths")
    tt = tuple(torch.from_numpy(t) for t in tabs)
    _assert_same(want, tsk.compute_sketch_batch(*tt), "compute_sketch_batch")
    _assert_same(want, kernel_model(*tabs), "kernel_model")


def _two_component_index(m, **kw):
    """Two 8-cycles with chords, landmarks in both, and an isolated vertex
    (an all-INF label row)."""
    a = [(i, (i + 1) % 8) for i in range(8)] + [(0, 4), (2, 6)]
    edges = np.array(a + [(x + 8, y + 8) for x, y in a])
    return m.from_edges(edges, 17, **kw)


@pytest.mark.parametrize("packed", [False, True])
def test_landmarks_in_two_components(packed):
    gj, gt = _two_component_index(jg), _two_component_index(tg, device="cpu")
    lms = np.array([0, 3, 9, 12], np.int32)
    sj = jl.build_labelling(gj, lms)
    st = tl.build_labelling(gt, lms, device="cpu")
    if packed:
        pj, pt = jp.pack_labelling(sj), tp.pack_labelling(st)
        tabs_j = (pj.label_dist, pj.meta_w, pj.meta_dist)
        tabs_t = (pt.label_dist, pt.meta_w, pt.meta_dist)
    else:
        tabs_j = (sj.label_dist, sj.meta_w, sj.meta_dist)
        tabs_t = (st.label_dist, st.meta_w, st.meta_dist)
    us, vs = np.meshgrid(np.arange(17), np.arange(17))
    us, vs = us.ravel(), vs.ravel()
    want = jsk.compute_sketch_batch(tabs_j[0][jnp.asarray(us)],
                                    tabs_j[0][jnp.asarray(vs)], tabs_j[1],
                                    tabs_j[2], use_pallas=True)
    lu, lv = tabs_t[0][torch.from_numpy(us)], tabs_t[0][torch.from_numpy(vs)]
    got = tsk.compute_sketch_batch(lu, lv, tabs_t[1], tabs_t[2])
    _assert_same(want, got, "compute_sketch_batch")
    _assert_same(want, ref.sketch_batch_ref(lu, lv, tabs_t[1], tabs_t[2]),
                 "sketch_batch_ref")
    assert bool((tp.widen_dist(tabs_t[2]) == INF).any())    # unreachable pairs
    apart = (us < 8) != (vs < 8)
    apart |= (us == 16) | (vs == 16)
    none = got.d_top.numpy() == INF
    assert none[apart].all() and not none.all()
    assert bool((got.du_land[torch.from_numpy(none)] == INF).all())
    assert bool((got.dv_land[torch.from_numpy(none)] == INF).all())
    assert not bool(got.meta_edge[torch.from_numpy(none)].any())
    assert not bool(got.d_star_u[torch.from_numpy(none)].any())
    assert not bool(got.d_star_v[torch.from_numpy(none)].any())


def test_uint16_promotion_path():
    """The 300-vertex path of ``test_high_diameter_path_promotes_to_uint16``:
    packed uint16 rows and tables."""
    gj = jg.grid_graph(1, 300)
    gt = tg.grid_graph(1, 300, device="cpu")
    lms = np.array([0, 299], np.int32)
    pj = jp.pack_labelling(jl.build_labelling(gj, lms, max_levels=400))
    pt = tp.pack_labelling(tl.build_labelling(gt, lms, max_levels=400, device="cpu"))
    assert pt.label_dist.dtype == torch.uint16
    us = np.array([0, 10, 150, 299, 42, 7, 3, 200], np.int32)
    vs = np.array([299, 290, 150, 0, 257, 298, 5, 100], np.int32)
    want = jsk.compute_sketch_batch(pj.label_dist[jnp.asarray(us)],
                                    pj.label_dist[jnp.asarray(vs)], pj.meta_w,
                                    pj.meta_dist, use_pallas=True)
    lu = pt.label_dist[torch.from_numpy(us).long()]
    lv = pt.label_dist[torch.from_numpy(vs).long()]
    _assert_same(want, tsk.compute_sketch_batch(lu, lv, pt.meta_w, pt.meta_dist),
                 "compute_sketch_batch")
    _assert_same(want, kernel_model(lu.numpy(), lv.numpy(), pt.meta_w.numpy(),
                                    pt.meta_dist.numpy()), "kernel_model")
    assert int(want.d_top.max()) >= 255


def test_sketch_batch_checks_shapes():
    z = torch.zeros((3, 4), dtype=torch.int32)
    t = torch.zeros((4, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="one"):
        tsk.compute_sketch_batch(z, z[:2], t, t)
    with pytest.raises(ValueError, match="meta tables"):
        tsk.compute_sketch_batch(z, z, t[:3], t)
    with pytest.raises(ValueError, match="R >= 1"):
        tsk.compute_sketch_batch(z[:, :0], z[:, :0], t[:0, :0], t[:0, :0])


@pytest.mark.parametrize("r,want", [(1, (True, 60)), (20, (True, 3480)),
                                    (168, (True, 231248)), (169, (False, 1432)),
                                    (200, (False, 1688))])
def test_smem_layout(r, want):
    """Tables staged in shared memory up to R = 168, read through L2 above."""
    assert smem_layout(r) == want
