"""Port vs reference: ``serving/serve_step.py``'s steps.

LM: ``make_prefill_step`` (the prefill, or for the encoder-only model the
forward with no cache) and ``make_decode_step`` equal the reference's
steps on its reduced weights (through ``repro_torch.convert.
lm_from_numpy``), one architecture per family.  SPG: ``make_spg_serve_step``
and ``serve_spg_batch`` equal the reference's on a small graph on all
three relay backends, and ``core.to_networkx`` gives the reference's edge
set.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from helpers.torch_lm import (  # noqa: E402
    F32_TOL,
    FAMILY_ARCH,
    batch_np,
    j_batch,
    port,
    reference,
    t_batch,
    to_np,
)

from repro.core import QbSIndex as JIndex  # noqa: E402
from repro.core import barabasi_albert_graph as j_ba  # noqa: E402
from repro.core.graph import to_networkx as j_to_networkx  # noqa: E402
from repro.serving import make_spg_serve_step as j_make_spg_serve_step  # noqa: E402
from repro.serving import serve_spg_batch as j_serve_spg_batch  # noqa: E402
from repro_torch.core import QbSIndex, barabasi_albert_graph, to_networkx  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    make_decode_step,
    make_prefill_step,
    make_spg_serve_step,
    serve_spg_batch,
)


@pytest.mark.parametrize("family", sorted(FAMILY_ARCH))
def test_prefill_and_decode_steps(family):
    """``make_prefill_step``: the prefill (or, encoder-only, the forward
    with no cache); ``make_decode_step``: ``decode_step``.  Both equal the
    reference's steps."""
    name = FAMILY_ARCH[family]
    cfg, jm, params = reference(name)
    tm = port(name)
    batch = batch_np(cfg, seed=4)      # 64 tokens
    logits, cache = make_prefill_step(tm)(t_batch(batch))
    assert not logits.requires_grad
    if cfg.encoder_only:
        want, _ = jm.forward(params, batch=j_batch(batch))
        assert cache is None
        np.testing.assert_allclose(to_np(logits), np.asarray(want), rtol=1e-4, atol=1e-4)
        return
    want, _ = jm.prefill(params, batch=j_batch(batch))
    tol = F32_TOL[cfg.family]
    np.testing.assert_allclose(to_np(logits), np.asarray(want), rtol=tol, atol=tol)
    # the module's own entry points are the same functions
    assert torch.equal(tm.prefill(t_batch(batch))[0], logits)
    with torch.inference_mode():
        assert torch.equal(tm(t_batch(batch))[0][:, -1:], logits)
    # one token into fresh caches of both packages
    tok = np.full((2, 1), 3, np.int32)
    got, _ = make_decode_step(tm)(tm.init_decode_cache(2, 4), 0, torch.as_tensor(tok))
    assert torch.equal(tm.decode(tm.init_decode_cache(2, 4), 0, torch.as_tensor(tok))[0], got)
    want, _ = jm.decode(params, cache=jm.init_decode_cache(2, 4), cache_len=jnp.int32(0),
                        tokens=jnp.asarray(tok))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=tol, atol=tol)


# -- SPG half -----------------------------------------------------------------


@pytest.fixture(scope="module")
def spg_pair():
    jg = j_ba(300, 3, seed=11)
    tg = barabasi_albert_graph(300, 3, seed=11, device="cpu")
    jidx = JIndex.build(jg, n_landmarks=6, chunk=8)
    lms = np.array(jidx.scheme.landmarks)
    return jg, tg, jidx, lms


@pytest.mark.parametrize("backend", ["segment", "csr", "hybrid"])
def test_spg_serve_step_and_batch_equal_the_references(spg_pair, backend):
    jg, tg, jidx, lms = spg_pair
    idx = QbSIndex.build(tg, landmarks=lms, chunk=8, backend=backend, device="cpu",
                         engine_opts={"n_hubs": 32} if backend == "hybrid" else None)
    rng = np.random.default_rng(0)
    non = np.setdiff1d(np.arange(300), lms)
    us = rng.choice(non, 8).astype(np.int32)
    vs = rng.choice(non, 8).astype(np.int32)
    step = make_spg_serve_step(idx)
    assert step == idx.serve_step
    dist, mask = step(torch.as_tensor(us), torch.as_tensor(vs))
    j_dist, j_mask = j_make_spg_serve_step(jidx)(jnp.asarray(us), jnp.asarray(vs))
    assert np.array_equal(to_np(dist), np.asarray(j_dist))
    assert np.array_equal(to_np(mask), np.asarray(j_mask))
    # arbitrary batches with every lane: landmark pairs, one-sided, u == v
    bu = np.concatenate([rng.integers(0, 300, 20), lms[:2], lms[:1], [5]]).astype(np.int32)
    bv = np.concatenate([rng.integers(0, 300, 20), lms[2:4], non[:1], [5]]).astype(np.int32)
    d, m = serve_spg_batch(idx, bu, bv)
    jd, jm = j_serve_spg_batch(jidx, bu, bv)
    assert isinstance(d, np.ndarray) and isinstance(m, np.ndarray)
    assert np.array_equal(d, np.asarray(jd))
    assert np.array_equal(m, np.asarray(jm))


def test_to_networkx_matches_the_reference(spg_pair):
    pytest.importorskip("networkx")
    jg, tg, _, _ = spg_pair
    pad = barabasi_albert_graph(50, 2, seed=1, device="cpu", pad_vertices_to=64,
                                pad_edges_to=512)
    for got, want in ((to_networkx(tg), j_to_networkx(jg)),
                      (to_networkx(pad), j_to_networkx(
                          j_ba(50, 2, seed=1, pad_vertices_to=64, pad_edges_to=512)))):
        assert sorted(got.nodes) == sorted(want.nodes)
        assert {tuple(sorted(e)) for e in got.edges} == \
            {tuple(sorted(e)) for e in want.edges}
        assert not any(a == b for a, b in got.edges)
    assert to_networkx(pad).number_of_nodes() == 64
