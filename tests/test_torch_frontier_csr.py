"""Port vs reference: the ``csr`` relay backend and its reduction.

The pull relay over the src-sorted layout (``make_relay(backend="csr")``),
unblocked and with ``block_size`` (one that divides E, one that does not,
one larger than E), with and without a symmetric edge mask, against the
reference's ``csr`` engine on the graphs of ``tests/test_frontier_engine.py``
and against the port's own ``segment`` relay; ``csr_or`` against
``segment_or`` on a sorted key with empty segments.  Every comparison is
exact, with zero tolerance: the relay is boolean.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import frontier as jf  # noqa: E402
from repro.core import graph as jg  # noqa: E402
from repro_torch.core import frontier as tf  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402


# the graphs of tests/test_frontier_engine.py, built by both packages
ENGINE_GRAPHS = {
    "gnp": lambda m, **kw: m.gnp_random_graph(60, 3.0, seed=7, **kw),
    "barabasi_albert": lambda m, **kw: m.barabasi_albert_graph(70, 2, seed=3, **kw),
    "random_regular": lambda m, **kw: m.random_regular_graph(48, 4, seed=5, **kw),
    "ring_of_cliques": lambda m, **kw: m.ring_of_cliques(6, 5, **kw),
    "grid": lambda m, **kw: m.grid_graph(6, 6, **kw),
}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", sorted(ENGINE_GRAPHS))
def test_csr_relay_matches_reference(name, masked):
    """``csr`` unblocked, with a block that divides E, one that does not,
    and one larger than E, against the reference's ``csr`` engine."""
    gj = ENGINE_GRAPHS[name](jg)
    gt = ENGINE_GRAPHS[name](tg, device="cpu")
    rng = np.random.default_rng(13)
    mask = None
    if masked:   # vertex-factored, hence symmetric (the G- shape)
        vkeep = rng.random(gj.n_vertices) < 0.7
        mask = vkeep[np.asarray(gj.src)] & vkeep[np.asarray(gj.dst)]
    f = rng.random((5, gj.n_vertices)) < 0.25
    e = gj.n_edges
    divisor = next(d for d in range(2, e) if e % d == 0 and d < e)
    for block in (0, 64, divisor, e + 5):
        ej = jf.make_relay(gj, backend="csr", edge_mask=mask, block_size=block)
        et = tf.make_relay(gt, backend="csr", edge_mask=mask, block_size=block)
        want = np.asarray(ej.relay(jnp.asarray(f)))
        got = et.relay(torch.from_numpy(f))
        assert got.dtype == torch.bool
        assert np.array_equal(got.numpy(), want), block
        assert np.array_equal(et.relay(torch.from_numpy(f[1])).numpy(), want[1])
        seg = tf.make_relay(gt, backend="segment", edge_mask=mask)
        assert torch.equal(got, seg.relay(torch.from_numpy(f)))


def test_csr_or_empty_segments():
    """A sorted key with empty segments (and segments past the last key)
    comes out False, as ``segment_or``'s does."""
    rng = np.random.default_rng(1)
    ids = np.sort(rng.integers(0, 6, size=30)).astype(np.int32)
    ids[ids == 3] = 2                                    # segment 3 empty too
    msgs = rng.random((4, 30)) < 0.3
    bounds = torch.searchsorted(torch.from_numpy(ids), torch.arange(11, dtype=torch.int32))
    got = tf.csr_or(torch.from_numpy(msgs), bounds)
    want = tf.segment_or(torch.from_numpy(msgs), torch.from_numpy(ids), 10)
    assert torch.equal(got, want)
    assert not got[:, 3].any() and not got[:, 6:].any()
    assert not tf.csr_or(torch.zeros((2, 30), dtype=torch.bool), bounds).any()
