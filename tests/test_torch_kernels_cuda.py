"""The CUDA kernels against their plain PyTorch versions, on the card.

Every case carries the ``cuda`` marker and skips on a machine without a
CUDA card (decided in a fixture when the test runs).  This file imports
neither JAX nor the JAX package, so it runs on the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Comparisons are exact, with zero tolerance: the min-plus product and the
sketch are integer, the frontier expansion, the relay and the side attach
boolean.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.graph import INF  # noqa: E402
from repro_torch.core.packing import pack_bits  # noqa: E402
from repro_torch.kernels import LAUNCHES, ops, ref  # noqa: E402

MINPLUS_SHAPES = [(1, 1, 1), (8, 20, 20), (32, 20, 20), (128, 128, 128),
                  (130, 20, 50), (256, 64, 129), (5, 200, 7), (4, 4, 4)]


@pytest.fixture
def cuda_device():
    """The card, decided when a test runs (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels compile and run only there")
    return torch.device("cuda")


def _rand_dist(rng, shape, dev):
    x = rng.integers(0, 64, size=shape)
    x = np.where(rng.random(shape) < 0.2, INF, x).astype(np.int32)
    return torch.from_numpy(x).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", MINPLUS_SHAPES)
def test_minplus_kernel_matches_plain(cuda_device, m, k, n):
    rng = np.random.default_rng(m + k + n)
    a, b = _rand_dist(rng, (m, k), cuda_device), _rand_dist(rng, (k, n), cuda_device)
    count = LAUNCHES["minplus"]
    got = ops.minplus(a, b)
    assert LAUNCHES["minplus"] == count + 1
    assert torch.equal(got, ref.minplus_ref(a, b))


@pytest.mark.cuda
def test_minplus_kernel_saturates_and_refuses(cuda_device):
    a = torch.full((4, 4), INF, dtype=torch.int32, device=cuda_device)
    assert bool((ops.minplus(a, a) >= 2 * INF).all())
    with pytest.raises(ValueError, match="widen"):
        ops.minplus(a.to(torch.uint8), a)
    with pytest.raises(ValueError, match="contiguous"):
        ops.minplus(a.T, a)


@pytest.mark.cuda
@pytest.mark.parametrize("k,v,w", [(40, 128, 128), (32, 128, 128), (64, 128, 128),
                                   (40, 128, 100), (17, 70, 90), (5, 3000, 40),
                                   (300, 16, 16), (7, 1, 40), (9, 33, 70),
                                   (32, 2048, 128), (3, 2048, 2100)])
def test_bitmap_expand_packed_kernel_matches_plain(cuda_device, k, v, w):
    """Staged words (V * NW * 4 <= 48 KB) and words read through L2, more
    than 32 words a row, and an all-False frontier."""
    rng = np.random.default_rng(k + v + w)
    f = torch.from_numpy(rng.random((k, v)) < 0.3).to(cuda_device)
    words = pack_bits(torch.from_numpy(rng.random((v, w)) < 0.1)).to(cuda_device)
    count = LAUNCHES["bitmap_expand_packed"]
    got = ops.bitmap_expand_packed(f, words, n_cols=w)
    assert LAUNCHES["bitmap_expand_packed"] == count + 1
    assert torch.equal(got, ref.bitmap_expand_packed_ref(f, words, w))
    none = ops.bitmap_expand_packed(torch.zeros_like(f), words, n_cols=w)
    assert not bool(none.any())


@functools.lru_cache(maxsize=None)
def _skewed_graph(n):
    """A Barabasi-Albert graph: its longest tail rows (hubs and more) take
    the kernel's warp-per-row path."""
    from repro_torch.core.graph import barabasi_albert_graph

    return barabasi_albert_graph(n, 3, seed=0, device="cuda")


def _gminus(g, n_landmarks=20):
    from repro_torch.core.graph import select_landmarks

    keep = torch.ones((g.n_vertices,), dtype=torch.bool, device=g.device)
    keep[torch.from_numpy(select_landmarks(g, n_landmarks)).to(g.device).long()] = False
    return keep[g.src.long()] & keep[g.dst.long()]


def _relay_both(engine, f):
    a = engine.arrays
    args = (f, a["tail_ptr"], a["tail_col"], a["hub_ids"], a["adj_hh_words"])
    count = LAUNCHES["hybrid_relay"]
    got = ops.hybrid_relay(*args)
    assert LAUNCHES["hybrid_relay"] == count + 1
    return got, ref.hybrid_relay_ref(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 31, 32, 33, 40, 65])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [20000, 20001])
def test_hybrid_relay_kernel_matches_plain(cuda_device, n, masked, k):
    """On a skewed graph (V % 4 == 0 packs with word loads, else bytes),
    with and without the G- mask, at every relay width; an all-False
    frontier relays to nothing."""
    from repro_torch.core.frontier import make_relay
    from repro_torch.kernels.frontier import cached_schedule

    g = _skewed_graph(n)
    eng = make_relay(g, backend="hybrid", edge_mask=_gminus(g) if masked else None)
    warp_rows, _ = cached_schedule(eng.arrays["tail_ptr"], eng.arrays["hub_ids"])
    assert warp_rows.shape[0] > eng.arrays["hub_ids"].shape[0]
    rng = np.random.default_rng(k)
    f = torch.from_numpy(rng.random((k, n)) < 0.05).to(cuda_device)
    got, want = _relay_both(eng, f)
    assert torch.equal(got, want)
    got, want = _relay_both(eng, torch.zeros_like(f))
    assert not bool(got.any()) and not bool(want.any())


@pytest.mark.cuda
@pytest.mark.parametrize("n_hubs", [1, 5, 12, 200, 5000])
def test_hybrid_relay_kernel_hub_counts(cuda_device, n_hubs):
    """From one hub to every vertex a hub (an empty tail apart from the
    self-loop padding), on a padded graph with isolated vertices."""
    from repro_torch.core.frontier import make_relay
    from repro_torch.core.graph import barabasi_albert_graph

    g = barabasi_albert_graph(3000, 3, seed=1, pad_vertices_to=3010,
                              pad_edges_to=18000, device=cuda_device)
    eng = make_relay(g, backend="hybrid", n_hubs=n_hubs)
    rng = np.random.default_rng(n_hubs)
    for k in (1, 32, 40):
        f = torch.from_numpy(rng.random((k, g.n_vertices)) < 0.1).to(cuda_device)
        got, want = _relay_both(eng, f)
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("r,v,w", [(1, 1, 1), (8, 128, 128), (20, 100, 100),
                                   (20, 257, 257), (3, 300, 300), (64, 512, 512),
                                   (40, 128, 128), (17, 70, 90), (33, 1000, 5),
                                   (64, 2048, 2048), (17, 33, 65),
                                   (130, 4099, 257)])
@pytest.mark.parametrize("density", [0.0, 0.02, 0.5])
def test_bitmap_expand_kernel_matches_plain(cuda_device, r, v, w, density):
    rng = np.random.default_rng(r + v + w)
    f = torch.from_numpy(rng.random((r, v)) < 0.1).to(cuda_device)
    adj = torch.from_numpy(rng.random((v, w)) < density).to(cuda_device)
    count = LAUNCHES["bitmap_expand"]
    got = ops.bitmap_expand(f, adj)
    assert LAUNCHES["bitmap_expand"] == count + 1
    assert torch.equal(got, ref.bitmap_expand_ref(f, adj))
    none = ops.bitmap_expand(torch.zeros_like(f), adj)   # all-False frontier
    assert not bool(none.any())


@pytest.mark.cuda
def test_hybrid_relay_kernel_refuses(cuda_device):
    from repro_torch.core.frontier import make_relay

    eng = make_relay(_skewed_graph(20000), backend="hybrid")
    a = eng.arrays
    args = [a["tail_ptr"], a["tail_col"], a["hub_ids"], a["adj_hh_words"]]
    f = torch.zeros((4, 20000), dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="mixed"):
        ops.hybrid_relay(f.cpu(), *args)
    with pytest.raises(ValueError, match="contiguous"):
        ops.hybrid_relay(torch.zeros((20000, 4), dtype=torch.bool,
                                     device=cuda_device).T, *args)
    with pytest.raises(ValueError, match="int32"):
        ops.hybrid_relay(f, args[0].long(), *args[1:])


@pytest.mark.cuda
def test_bitmap_expand_kernel_refuses(cuda_device):
    f = torch.zeros((4, 8), dtype=torch.bool, device=cuda_device)
    adj = torch.zeros((8, 6), dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="mixed"):
        ops.bitmap_expand(f.cpu(), adj)
    with pytest.raises(ValueError, match="bool"):
        ops.bitmap_expand(f, adj.to(torch.uint8))
    with pytest.raises(ValueError, match="contiguous"):
        ops.bitmap_expand(f, torch.zeros((6, 8), dtype=torch.bool,
                                         device=cuda_device).T)
    with pytest.raises(ValueError, match="bad shapes"):
        ops.bitmap_expand(f, adj.T.contiguous())


@pytest.mark.cuda
def test_uint16_tables_serve_on_the_card(cuda_device):
    """A 300-vertex path promotes the packed tables to uint16, which CUDA
    cannot index directly; the card's answers equal the CPU's."""
    from repro_torch.core import QbSIndex, grid_graph

    us = np.array([0, 10, 150, 299, 42, 7, 3], np.int32)
    vs = np.array([299, 290, 150, 0, 257, 298, 5], np.int32)
    out = []
    for dev in ("cpu", cuda_device):
        g = grid_graph(1, 300, device=dev)
        idx = QbSIndex.build(g, landmarks=np.array([0, 299], np.int32), chunk=4,
                             max_levels=400, device=dev)
        assert idx.packed.label_dist.dtype == torch.uint16
        out.append(idx.query_batch_arrays(us, vs))
    assert np.array_equal(out[0][0], out[1][0])
    assert np.array_equal(out[0][1], out[1][1])


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 3])
def test_sharded_uint16_tables_serve_on_the_card(cuda_device, shards):
    """The vertex-sharded index on shards of the one card, with uint16
    tables (moved between shards as their int16 view): the answers equal
    the single-device index's on the CPU."""
    from repro_torch.core import Mesh, QbSIndex, build_labelling, grid_graph

    us = np.array([0, 10, 150, 299, 42, 7, 3], np.int32)
    vs = np.array([299, 290, 150, 0, 257, 298, 5], np.int32)
    lms = np.array([0, 299], np.int32)
    kw = dict(chunk=6, max_levels=400, max_chain=400)
    g = grid_graph(1, 300, device="cpu")
    want = QbSIndex(g, build_labelling(g, lms, max_levels=400, device="cpu"),
                    **kw).query_batch_arrays(us, vs)
    assert want[0][0] == 299
    g = g.to(cuda_device)
    mesh = Mesh([cuda_device] * shards)
    sh = QbSIndex.build(g, landmarks=lms, sharded=mesh, build_max_levels=400, **kw)
    assert sh.labels.labels_sh[0].dtype == torch.uint16
    got = sh.query_batch_arrays(us, vs)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


@pytest.mark.cuda
def test_bitmap_expand_kernel_unaligned_bases(cuda_device):
    """Rows of 16-byte multiples from a base that is not 16-byte aligned take
    the byte-load path and give the same bits."""
    from repro_torch.kernels.frontier import dense_vector_loads

    rng = np.random.default_rng(3)
    f = torch.from_numpy(rng.random((40, 128)) < 0.2).to(cuda_device)
    adj = torch.from_numpy(rng.random((128, 128)) < 0.05).to(cuda_device)
    shifted = torch.zeros(128 * 128 + 1, dtype=torch.bool, device=cuda_device)
    shifted[1:] = adj.reshape(-1)
    adj_off = shifted[1:].view(128, 128)
    assert dense_vector_loads(f, adj) and not dense_vector_loads(f, adj_off)
    want = ref.bitmap_expand_ref(f, adj)
    assert torch.equal(ops.bitmap_expand(f, adj), want)
    assert torch.equal(ops.bitmap_expand(f, adj_off), want)


def _np_meta_tables(rng, r, kind, scale):
    """int32 (meta_w, meta_dist): a random meta graph and its APSP (with
    the landmarks in two components for ``two_components``), or arbitrary
    asymmetric tables."""
    if kind == "asymmetric":
        w = rng.integers(1, 3 * scale + 1, size=(r, r))
        d = rng.integers(0, 3 * scale + 1, size=(r, r))
        return (np.where(rng.random((r, r)) < 0.3, INF, w).astype(np.int32),
                np.where(rng.random((r, r)) < 0.15, INF, d).astype(np.int32))
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


def _sketch_inputs(rng, b, r, dtype, kind="apsp"):
    """(lu, lv, meta_w, meta_dist) on the card, packed into ``dtype``
    (sentinel = dtype max) or int32; 20% INF entries and some all-INF rows."""
    hi, scale = (400, 50) if dtype == "uint16" else (40, 2)
    tabs = []
    for _ in range(2):
        x = rng.integers(0, hi, size=(b, r))
        x = np.where(rng.random((b, r)) < 0.2, INF, x)
        x[rng.random(b) < 0.1] = INF
        tabs.append(x)
    tabs += _np_meta_tables(rng, r, kind, scale)
    out = []
    for x in tabs:
        if dtype != "int32":
            x = np.where(x >= INF, np.iinfo(dtype).max, x).astype(dtype)
        out.append(torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)))
    return [t.to("cuda") for t in out]


def _sketch_both(*args):
    count = LAUNCHES["sketch_batch"]
    got = ops.sketch_batch(*args)
    assert LAUNCHES["sketch_batch"] == count + 1
    want = ref.sketch_batch_ref(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 7, 8, 32])
@pytest.mark.parametrize("r", [1, 2, 5, 20, 33, 64, 130])
@pytest.mark.parametrize("dtype", ["uint8", "uint16", "int32"])
def test_sketch_batch_kernel_matches_plain(cuda_device, dtype, r, b):
    """Tables staged in shared memory (R = 64 and 130 above 48 KB)."""
    from repro_torch.kernels.sketch import smem_layout

    assert smem_layout(r)[0]
    rng = np.random.default_rng(100 * r + b)
    _sketch_both(*_sketch_inputs(rng, b, r, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["uint8", "uint16", "int32"])
def test_sketch_batch_kernel_unstaged(cuda_device, dtype):
    """R = 170: the tables are read through L2 and the attaining-pair
    bitmap lives in global scratch."""
    from repro_torch.kernels.sketch import smem_layout

    assert not smem_layout(170)[0]
    rng = np.random.default_rng(170)
    _sketch_both(*_sketch_inputs(rng, 5, 170, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["two_components", "asymmetric"])
@pytest.mark.parametrize("dtype", ["uint8", "uint16", "int32"])
def test_sketch_batch_kernel_table_kinds(cuda_device, dtype, kind):
    """Unreachable landmark pairs (INF meta entries, d_top == INF, empty
    sketches) and arbitrary tables."""
    rng = np.random.default_rng(len(kind) + len(dtype))
    lu, lv, mw, md = _sketch_inputs(rng, 32, 20, dtype, kind)
    got = _sketch_both(lu, lv, mw, md)
    if kind == "two_components":
        assert bool((got[0] == INF).any())


@pytest.mark.cuda
def test_sketch_batch_kernel_refuses(cuda_device):
    lu, lv, mw, md = _sketch_inputs(np.random.default_rng(0), 4, 5, "uint8")
    with pytest.raises(ValueError, match="one dtype"):
        ops.sketch_batch(lu, lv, mw.to(torch.int32), md)
    with pytest.raises(ValueError, match="one dtype"):
        ops.sketch_batch(*(t.to(torch.int64) for t in (lu, lv, mw, md)))
    with pytest.raises(ValueError, match="contiguous"):
        ops.sketch_batch(lu, lv, mw.T, md)
    with pytest.raises(ValueError, match="mixed"):
        ops.sketch_batch(lu.cpu(), lv, mw, md)


@pytest.mark.cuda
@pytest.mark.parametrize("r,v,w", [(40, 128, 128), (17, 33, 65), (64, 2048, 2048)])
def test_bitmap_expand_kernel_bool_bytes(cuda_device, r, v, w):
    """Bool bytes of 2 and 255 (made through a uint8 view) count as True:
    a 255 is -1 as s8 and must not cancel a count."""
    rng = np.random.default_rng(r + v)
    vals = np.array([0, 1, 2, 255], np.uint8)
    fb = vals[rng.choice(4, size=(r, v), p=[0.85, 0.05, 0.05, 0.05])]
    ab = vals[rng.choice(4, size=(v, w), p=[0.94, 0.02, 0.02, 0.02])]
    f = torch.from_numpy(fb).to(cuda_device).view(torch.bool)
    adj = torch.from_numpy(ab).to(cuda_device).view(torch.bool)
    want = ref.bitmap_expand_ref(torch.from_numpy(fb != 0).to(cuda_device),
                                 torch.from_numpy(ab != 0).to(cuda_device))
    got = ops.bitmap_expand(f, adj)
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("r,v,w", [(40, 128, 128), (64, 2048, 2048), (130, 4099, 257)])
def test_bitmap_expand_kernel_saturates(cuda_device, r, v, w):
    """An all-True frontier over an adjacency whose first row is all True:
    every block's outputs are true after its first stage and the block stops
    early; the rest of K holds random bits."""
    rng = np.random.default_rng(v)
    f = torch.ones((r, v), dtype=torch.bool, device=cuda_device)
    a = rng.random((v, w)) < 0.01
    a[0] = True
    adj = torch.from_numpy(a).to(cuda_device)
    got = ops.bitmap_expand(f, adj)
    assert bool(got.all())
    assert torch.equal(got, ref.bitmap_expand_ref(f, adj))


@pytest.mark.cuda
@pytest.mark.parametrize("r,v,w", [(40, 128, 128), (64, 2048, 2048), (17, 48, 64)])
@pytest.mark.parametrize("which", ["frontier", "adjacency", "both"])
def test_bitmap_expand_kernel_bases_off_by_one(cuda_device, r, v, w, which):
    """16-byte row pitches from bases 1 byte past an aligned address take
    the byte-load staging and give the same bits."""
    from repro_torch.kernels.frontier import dense_vector_loads

    def shifted(x):
        buf = torch.zeros(x.numel() + 1, dtype=torch.bool, device=cuda_device)
        buf[1:] = x.reshape(-1)
        return buf[1:].view(x.shape)

    rng = np.random.default_rng(r * v + w)
    f = torch.from_numpy(rng.random((r, v)) < 0.1).to(cuda_device)
    adj = torch.from_numpy(rng.random((v, w)) < 0.05).to(cuda_device)
    want = ref.bitmap_expand_ref(f, adj)
    f_off = shifted(f) if which != "adjacency" else f
    adj_off = shifted(adj) if which != "frontier" else adj
    assert dense_vector_loads(f, adj) and not dense_vector_loads(f_off, adj_off)
    assert torch.equal(ops.bitmap_expand(f_off, adj_off), want)


@pytest.mark.cuda
def test_stream_on_the_card_matches_query_batch(cuda_device):
    """The streaming scheduler on a hybrid index on the card (two QoS
    classes, the hub cache with reuse admission, ``ManualClock``): every
    future equals ``query_batch``, and its chunks ran the fused sketch and
    the fused relay."""
    from repro_torch.core import QbSIndex, barabasi_albert_graph
    from repro_torch.serving import ManualClock, QoSClass

    g = barabasi_albert_graph(3000, 3, seed=0, device=cuda_device)
    idx = QbSIndex.build(g, n_landmarks=8, chunk=16, backend="hybrid",
                         device=cuda_device)
    rng = np.random.default_rng(0)
    us = rng.integers(0, 3000, 120).astype(np.int32)
    vs = rng.integers(0, 3000, 120).astype(np.int32)
    want = idx.query_batch(us, vs)
    clock = ManualClock()
    st = idx.make_stream(clock=clock, cache_size=256, cache_policy="hub",
                         cache_admission="reuse",
                         qos=(QoSClass("interactive", max_wait=0.002, weight=3.0),
                              QoSClass("batch", max_wait=0.05)))
    ops.reset_launches()
    futs = []
    for rep in range(2):                   # the second pass joins and hits
        for k in range(0, 120, 15):
            futs += st.submit_batch(us[k:k + 15], vs[k:k + 15],
                                    qos=("interactive", "batch")[k // 15 % 2])
            clock.advance(0.001)
        clock.advance(0.1)
    st.drain()
    launched = dict(LAUNCHES)
    for f, w in zip(futs, want + want):
        r = f.result()
        assert (r.dist, r.d_top) == (w.dist, w.d_top)
        assert np.array_equal(r.edge_ids, w.edge_ids)
    assert launched["sketch_batch"] > 0 and launched["hybrid_relay"] > 0
    assert launched["side_attach"] > 0
    assert st.stats["cache_hits"] + st.stats["joined"] > 0
    st.close()


def _bits(t):
    """uint16 tensors compare through their int16 view, as they index."""
    return t.view(torch.int16) if t.dtype == torch.uint16 else t


@pytest.mark.cuda
def test_apply_update_on_the_card_matches_cpu(cuda_device):
    """Updates on a 257-vertex path with a shortcut: the cut repacks the
    tables to uint16, and a later insert patches the uint16 tables in place
    of a repack (written through their int16 view on the card).  The card's
    tables and answers equal the CPU's, and the source index is unchanged."""
    from repro_torch.core import QbSIndex, from_edges

    edges = np.asarray([(i, i + 1) for i in range(256)] + [(0, 128)])
    lms = np.array([0, 128], np.int32)
    us = np.array([0, 256, 5, 129], np.int32)
    vs = np.array([256, 128, 248, 127], np.int32)
    out = []
    for dev in ("cpu", cuda_device):
        idx = QbSIndex.build(from_edges(edges, 257, device=dev), landmarks=lms,
                             chunk=4, backend="hybrid", device=dev)
        before = [t.clone() for t in idx.packed]
        cut = idx.apply_update(deletes=[(0, 128)], churn_threshold=1.1)
        nxt = cut.apply_update(inserts=[(200, 202)], churn_threshold=1.1)
        assert nxt.packed.label_dist.dtype == torch.uint16
        assert all(torch.equal(_bits(a), _bits(b))
                   for a, b in zip(before, idx.packed))
        out.append(([t.cpu() for t in nxt.packed], nxt._lm_dist_host,
                    nxt.query_batch_arrays(us, vs)))
    (pc, lc, (dc, mc)), (pg, lg, (dg, mg)) = out
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(pc, pg))
    assert np.array_equal(lc, lg)
    assert np.array_equal(dc, dg) and np.array_equal(mc, mg)


SIDE_ATTACH_CASES = [(maker, kw, b)
                     for maker, kw in (("real", {"max_levels": 1}),
                                       ("real", {"max_levels": 2, "dtype": torch.uint16}),
                                       ("synthetic", {"seed": 1}),
                                       ("synthetic", {"seed": 2, "near_sentinel": True}),
                                       ("synthetic", {"seed": 3, "dtype": torch.uint16,
                                                      "near_sentinel": True}))
                     for b in (1, 31, 32, 33, 70, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("max_chain", [1, 64])
@pytest.mark.parametrize("maker,kw,b", SIDE_ATTACH_CASES)
def test_side_attach_kernel_matches_plain(cuda_device, maker, kw, b, max_chain):
    """The side attach's kernels against the plain version on a small BA
    graph's real depth tables and on arbitrary inputs (a row split into
    closure segments, labels beside the sentinel), uint8 and uint16: the
    edge mask, the word table and, with ``out``, the OR into it."""
    from helpers import side_attach_cases as cases

    a = {k: t.to(cuda_device) for k, t in getattr(cases, maker)(b=b, **kw).items()}
    count = LAUNCHES["side_attach"]
    got_e, got_on = ops.side_attach(**a, max_chain=max_chain)
    launches = LAUNCHES["side_attach"] - count
    want_e, want_on = ref.side_attach_ref(**a, max_chain=max_chain)
    assert torch.equal(got_on, want_on) and torch.equal(got_e, want_e)
    assert 3 <= launches <= 2 + max_chain
    prev = torch.rand(got_e.shape, device=cuda_device) < 0.1
    out = prev.clone()
    ops.side_attach(**a, max_chain=max_chain, out=out)
    assert torch.equal(out, prev | want_e)


@functools.lru_cache(maxsize=None)
def _sharded_index(n_shards, max_chain):
    from helpers import sharded_attach_cases as cases
    return cases.index(n_shards, max_chain, device=torch.device("cuda"), n=600)


@pytest.mark.cuda
@pytest.mark.parametrize("max_chain", [1, 16])
@pytest.mark.parametrize("b", [1, 17, 32, 35])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sharded_attach_kernels_match_plain(cuda_device, n_shards, b, max_chain):
    """The sharded attach's kernels against the plain per-landmark loop on
    one card's shards of a 600-vertex BA graph, inside ``general_lane`` on
    the same inputs: each shard's (B, E) edges bit for bit, launches per
    shard the certificate, each closure step and the edge pass."""
    from helpers import sharded_attach_cases as cases

    idx = _sharded_index(n_shards, max_chain)
    us, vs = cases.pairs(idx, b, seed=b)
    count = LAUNCHES["sharded_attach"]
    with cases.both_paths() as rec:
        idx.serve_step(us, vs)
    launches = LAUNCHES["sharded_attach"] - count
    (plain,), (kernel,), (steps,) = rec.plain, rec.kernel, rec.steps
    for p, k in zip(plain, kernel):
        assert p.is_cuda and k.is_cuda and torch.equal(p, k)
    assert 1 <= steps <= max_chain
    assert launches == n_shards * (2 + steps)


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [1, 4])
def test_sharded_index_on_the_card_launches_the_attach(cuda_device, n_shards):
    """Unpatched, the card's sharded index takes the kernels (never the
    plain loop) and answers as the same index on the CPU."""
    from helpers import sharded_attach_cases as cases

    idx = _sharded_index(n_shards, 16)
    cpu = cases.index(n_shards, 16, n=600)
    us, vs = cases.pairs(idx, 35, seed=7)
    count = LAUNCHES["sharded_attach"]
    d, m = idx.serve_step(us, vs)
    assert LAUNCHES["sharded_attach"] - count >= 3 * n_shards
    d_cpu, m_cpu = cpu.serve_step(us.cpu(), vs.cpu())
    assert torch.equal(d.cpu(), d_cpu) and torch.equal(m.cpu(), m_cpu)


@pytest.mark.cuda
def test_sharded_attach_across_cards(cuda_device):
    """On a mesh of every visible card (two or more), where the word tables
    cross between cards: the kernels equal the plain loop on each shard,
    and the index answers as on the CPU."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA cards: the tables cross between cards")
    from helpers import sharded_attach_cases as cases

    cards = [torch.device("cuda", i) for i in range(n)]
    idx = cases.index(n, 16, device=cards[0], devices=cards, n=600)
    cpu = cases.index(n, 16, n=600)
    us, vs = cases.pairs(idx, 35, seed=11)
    with cases.both_paths() as rec:
        d, m = idx.serve_step(us, vs)
    for s, (p, k) in enumerate(zip(rec.plain[0], rec.kernel[0])):
        assert k.device == cards[s] and torch.equal(p, k)
    d_cpu, m_cpu = cpu.serve_step(us.cpu(), vs.cpu())
    assert torch.equal(d.cpu(), d_cpu) and torch.equal(m.cpu(), m_cpu)
