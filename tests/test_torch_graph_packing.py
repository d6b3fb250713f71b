"""Port vs reference: graph construction and packed layouts.

The same seeds and numpy edge arrays go through ``repro.core`` (JAX) and
``repro_torch.core`` (PyTorch on the CPU).  Every comparison is exact, with
zero tolerance: the arrays are integer or boolean, and the port must
reproduce the reference's canonical edge order, generator draws, packed
dtype choice, sentinel encoding and bit-word layout bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import graph as jg  # noqa: E402
from repro.core import packing as jp  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core import packing as tp  # noqa: E402

INF = jg.INF

GENERATORS = {
    "gnp": lambda m, **kw: m.gnp_random_graph(40, 3.0, seed=1, **kw),
    "ba": lambda m, **kw: m.barabasi_albert_graph(60, 2, seed=3, **kw),
    "regular": lambda m, **kw: m.random_regular_graph(50, 4, seed=2, **kw),
    "ring": lambda m, **kw: m.ring_of_cliques(5, 4, **kw),
    "grid": lambda m, **kw: m.grid_graph(5, 6, **kw),
}


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same_graph(gj, gt):
    for name in ("indptr", "src", "dst"):
        a, b = np.asarray(getattr(gj, name)), _np(getattr(gt, name))
        assert b.dtype == np.int32, name
        assert np.array_equal(a, b), name


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_bit_identical(name, padded):
    gen = GENERATORS[name]
    gj = gen(jg)
    kw = {}
    if padded:
        kw = dict(pad_vertices_to=gj.n_vertices + 3, pad_edges_to=gj.n_edges + 10)
        gj = gen(jg, **kw)
    gt = gen(tg, device="cpu", **kw)
    _same_graph(gj, gt)
    assert gt.n_vertices == gj.n_vertices and gt.n_edges == gj.n_edges
    assert np.array_equal(tg.edge_set(gt), jg.edge_set(gj))
    assert np.array_equal(tg.select_landmarks(gt, 5), jg.select_landmarks(gj, 5))
    assert np.array_equal(gt.hub_mask(n_hubs=7), gj.hub_mask(n_hubs=7))
    assert np.array_equal(gt.hub_mask(top_frac=0.1), gj.hub_mask(top_frac=0.1))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_from_edges_with_loops_and_duplicates(seed):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, 25, size=(80, 2))
    edges = np.concatenate([edges, edges[:10, ::-1], [[3, 3], [7, 7]]])
    _same_graph(jg.from_edges(edges, 25), tg.from_edges(edges, 25, device="cpu"))
    _same_graph(jg.from_edges(edges, 25, pad_vertices_to=30, pad_edges_to=200),
                tg.from_edges(edges, 25, pad_vertices_to=30, pad_edges_to=200,
                              device="cpu"))
    _same_graph(jg.from_edges(np.zeros((0, 2)), 4),
                tg.from_edges(np.zeros((0, 2)), 4, device="cpu"))


def test_from_edges_padding_errors():
    with pytest.raises(ValueError):
        tg.from_edges([[0, 1]], 3, pad_vertices_to=2, device="cpu")
    with pytest.raises(ValueError):
        tg.from_edges([[0, 1], [1, 2]], 3, pad_edges_to=2, device="cpu")


@pytest.mark.parametrize("max_finite,want", [(0, np.uint8), (200, np.uint8),
                                             (254, np.uint8), (255, np.uint16),
                                             (1000, np.uint16), (65534, np.uint16)])
def test_choose_pack_dtype_and_round_trip(max_finite, want):
    rng = np.random.default_rng(max_finite)
    a = rng.integers(0, max_finite + 1, size=(9, 7)).astype(np.int32)
    a[0, 0] = max_finite
    a[rng.random(a.shape) < 0.3] = INF
    assert jp.choose_pack_dtype(a) == want
    assert tp.choose_pack_dtype(a) == want
    assert tp.choose_pack_dtype(torch.from_numpy(a)) == want
    pj = np.asarray(jp.pack_dist(a, want))
    pt = tp.pack_dist(a, want, device="cpu")
    assert pt.dtype == {np.uint8: torch.uint8, np.uint16: torch.uint16}[want]
    assert np.array_equal(pt.numpy(), pj)
    assert np.array_equal(tp.widen_dist(pt).numpy(), a)
    assert np.array_equal(tp.widen_dist(pt).numpy(), np.asarray(jp.widen_dist(pj)))
    assert tp.sentinel_of(pt.dtype) == jp.sentinel_of(want)


def test_pack_dtype_overflow_and_collisions():
    big = np.array([[65535]], np.int32)
    with pytest.raises(ValueError):
        tp.choose_pack_dtype(big)
    with pytest.raises(ValueError):
        tp.pack_dist(np.array([[255]], np.int32), np.uint8, device="cpu")
    # INF and the signed oracle path pass through
    x = torch.tensor([[3, INF]], dtype=torch.int32)
    assert torch.equal(tp.widen_dist(x), x)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 256])
def test_pack_bits_ragged(n):
    rng = np.random.default_rng(n)
    x = rng.random((5, n)) < 0.4
    wj = np.asarray(jp.pack_bits(jnp.asarray(x)))
    wt = tp.pack_bits(torch.from_numpy(x))
    assert wt.dtype == torch.int32 and wt.shape == (5, -(-n // 32))
    assert np.array_equal(wt.numpy().view(np.uint32), wj)
    assert np.array_equal(tp.unpack_bits(wt, n).numpy(), x)
    assert np.array_equal(tp.unpack_bits(wt, n).numpy(),
                          np.asarray(jp.unpack_bits(jnp.asarray(wj), n)))


def test_pad_width_ladder():
    for n in range(0, 70):
        assert tp.pad_width(n) == jp.pad_width(n)


def test_pack_labelling_matches_reference():
    from repro.core.labelling import build_labelling as j_build
    from repro_torch.core.labelling import build_labelling as t_build

    gj = jg.gnp_random_graph(40, 3.0, seed=5)
    gt = tg.gnp_random_graph(40, 3.0, seed=5, device="cpu")
    lms = jg.select_landmarks(gj, 4)
    sj = j_build(gj, lms)
    st = t_build(gt, lms, device="cpu")
    lm = np.asarray(sj.label_dist).T.copy()
    pj = jp.pack_labelling(sj, lm_dist=lm)
    pt = tp.pack_labelling(st, lm_dist=torch.from_numpy(lm))
    assert pt.dtype == pj.dtype and pt.sentinel == pj.sentinel
    assert pt.nbytes == pj.nbytes
    for a, b in zip(pj, pt):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert tp.packed_size_bytes(pt) == jp.packed_size_bytes(pj)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_take_gathers_packed_rows(dtype):
    """``take`` gathers rows (and element pairs) of a packed table bit for
    bit, uint16 through its int16 view."""
    from repro_torch.core.packing import pack_dist, take, widen_dist

    rng = np.random.default_rng(4)
    a = rng.integers(0, 250, size=(30, 6)).astype(np.int32)
    a[rng.random(a.shape) < 0.2] = INF
    t = pack_dist(a, dtype, device="cpu")
    rows = torch.tensor([3, 0, 29, 3], dtype=torch.int64)
    cols = torch.tensor([5, 1, 0, 2], dtype=torch.int64)
    got = take(t, rows)
    assert got.dtype == t.dtype
    assert np.array_equal(widen_dist(got).numpy(), a[rows.numpy()])
    assert np.array_equal(widen_dist(take(t, rows, cols)).numpy(),
                          a[rows.numpy(), cols.numpy()])
