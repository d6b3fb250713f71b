"""Port vs reference: the frontier engine.

``segment_or``, the relay (with and without the baked-in G- mask), the
batched BFS with per-row bounds and the single-source BFS, on the
``segment``, ``csr`` (with and without ``block_size``) and ``hybrid``
backends of both packages.  The reference's hybrid engine runs its Pallas
``bitmap_expand_packed`` kernel in interpret mode (``use_pallas=True,
interpret=True``); the port's takes the kernel's plain version on the CPU.
Every comparison is exact, with zero tolerance: the relay is boolean and
the depths are int32.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import frontier as jf  # noqa: E402
from repro.core import graph as jg  # noqa: E402
from repro_torch.core import frontier as tf  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402

INF = jg.INF


def _graphs():
    return {
        "gnp": (jg.gnp_random_graph(50, 3.0, seed=4),
                tg.gnp_random_graph(50, 3.0, seed=4, device="cpu")),
        "ba": (jg.barabasi_albert_graph(70, 2, seed=1),
               tg.barabasi_albert_graph(70, 2, seed=1, device="cpu")),
        "padded": (jg.grid_graph(5, 6, pad_vertices_to=33, pad_edges_to=120),
                   tg.grid_graph(5, 6, pad_vertices_to=33, pad_edges_to=120,
                                 device="cpu")),
    }


GRAPHS = _graphs()


def _gminus_mask(gj):
    lms = jg.select_landmarks(gj, 5)
    is_lm = np.zeros((gj.n_vertices,), bool)
    is_lm[lms] = True
    src, dst = np.asarray(gj.src), np.asarray(gj.dst)
    return ~is_lm[src] & ~is_lm[dst]


def _engines(name, backend, masked):
    gj, gt = GRAPHS[name]
    mask = _gminus_mask(gj) if masked else None
    kw = {"n_hubs": 12} if backend == "hybrid" else {}
    if backend == "csr":
        kw = {"block_size": 37}     # divides no graph's edge count here
    pallas = {"use_pallas": True, "interpret": True} if backend == "hybrid" else {}
    ej = jf.make_relay(gj, backend=backend, edge_mask=mask, **kw, **pallas)
    et = tf.make_relay(gt, backend=backend, edge_mask=mask, **kw)
    return gj, gt, ej, et


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("backend", ["segment", "csr", "hybrid"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_relay_matches_reference(name, backend, masked):
    gj, gt, ej, et = _engines(name, backend, masked)
    rng = np.random.default_rng(3)
    f = rng.random((7, gj.n_vertices)) < 0.15
    want = np.asarray(ej.relay(jnp.asarray(f)))
    got = et.relay(torch.from_numpy(f))
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), want)
    # the 1-D form
    assert np.array_equal(et.relay(torch.from_numpy(f[2])).numpy(), want[2])


@pytest.mark.parametrize("backend", ["segment", "csr", "hybrid"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_bfs_depths_batch_with_bounds(name, backend):
    gj, gt, ej, et = _engines(name, backend, masked=False)
    roots = np.array([0, 3, 7, 11, 3, gj.n_vertices - 1], np.int32)
    bounds = np.array([0, 1, 2, 64, 3, 5], np.int32)
    for b in (None, bounds):
        want = np.asarray(jf.bfs_depths_batch(
            ej, jnp.asarray(roots), 64,
            bounds=None if b is None else jnp.asarray(b)))
        got = tf.bfs_depths_batch(et, torch.from_numpy(roots), 64,
                                  bounds=None if b is None else torch.from_numpy(b))
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
    # a level cap below the diameter stops every row there
    want = np.asarray(jf.bfs_depths_batch(ej, jnp.asarray(roots), 2))
    got = tf.bfs_depths_batch(et, torch.from_numpy(roots), 2)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("backend", ["segment", "csr", "hybrid"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_bfs_depths_single_source(name, backend):
    gj, gt, ej, et = _engines(name, backend, masked=False)
    for root, bound in ((0, None), (7, None), (gj.n_vertices - 1, None),
                        (3, 0), (3, 2), (11, 64)):
        want = np.asarray(jf.bfs_depths(
            ej, jnp.int32(root), 64,
            bound=None if bound is None else jnp.int32(bound)))
        got = tf.bfs_depths(et, root, 64, bound=bound)
        assert got.dtype == torch.int32 and got.shape == (gj.n_vertices,)
        assert np.array_equal(got.numpy(), want)
    want = np.asarray(jf.bfs_depths(ej, jnp.int32(5), 1))
    assert np.array_equal(tf.bfs_depths(et, torch.tensor(5), 1).numpy(), want)


def test_segment_or_empty_segments():
    rng = np.random.default_rng(0)
    msgs = rng.random((4, 30)) < 0.3
    ids = rng.integers(0, 6, size=30).astype(np.int32)   # segments 6..9 empty
    want = np.asarray(jf.segment_or(jnp.asarray(msgs), jnp.asarray(ids), 10))
    got = tf.segment_or(torch.from_numpy(msgs), torch.from_numpy(ids), 10)
    assert np.array_equal(got.numpy(), want)
    assert not got[:, 6:].any()
    none = tf.segment_or(torch.zeros((2, 30), dtype=torch.bool),
                         torch.from_numpy(ids), 10)
    assert not none.any()


@pytest.mark.parametrize("n_hubs", [None, 1, 5, 200])
def test_hub_split_matches_reference(n_hubs):
    gj, gt = GRAPHS["ba"]
    hj, ht = jf.hub_split(gj, n_hubs), tf.hub_split(gt, n_hubs)
    for a, b in zip(hj, ht):
        assert np.array_equal(a, b)
    words = tf.make_relay(gt, backend="hybrid", n_hubs=n_hubs).arrays["adj_hh_words"]
    words_j = jf.make_relay(gj, backend="hybrid", n_hubs=n_hubs).arrays["adj_hh_words"]
    assert np.array_equal(words.numpy().view(np.uint32), np.asarray(words_j))


def test_unknown_backend_refused():
    _, gt = GRAPHS["gnp"]
    for backend in ("dense", "pull", ""):
        with pytest.raises(ValueError):
            tf.make_relay(gt, backend=backend)
    with pytest.raises(ValueError):
        tf.FrontierEngine({}, backend="dense", n_vertices=1, n_edges=0)
    assert tf.BACKENDS == jf.BACKENDS
