"""Port vs reference: guided search (Algorithm 4), stage by stage.

The reference writes each stage for one query and runs it under
``jax.vmap``; the port writes the ``(B, ...)`` loops out with per-row active
masks.  Here both run on the same labelling, sketches and query batch
(landmark endpoints, ``u == v`` and disconnected pairs included), on the
``segment`` and ``hybrid`` engines (the reference's hybrid kernel in
interpret mode), and every stage's outputs must be equal: the
bidirectional BFS state, the reverse sweep, each side's recover closure
(``on`` and its edges), the Delta edges and the full ``guided_search``.
Every comparison is exact, with zero tolerance (int32 and boolean).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import graph as jg  # noqa: E402
from repro.core import search as js  # noqa: E402
from repro.core.labelling import build_labelling as j_build  # noqa: E402
from repro.core.sketch import compute_sketch_batch as j_sketch  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core import search as ts  # noqa: E402
from repro_torch.core.labelling import build_labelling as t_build  # noqa: E402
from repro_torch.core.sketch import compute_sketch_batch as t_sketch  # noqa: E402
from repro_torch.kernels.ref import unpack_on  # noqa: E402

INF = jg.INF
EDGES = np.concatenate([np.random.default_rng(4).integers(0, 40, size=(70, 2)),
                        np.random.default_rng(5).integers(40, 52, size=(14, 2))])
MAX_LEVELS = MAX_CHAIN = 64


@pytest.fixture(scope="module", params=["segment", "hybrid"])
def setup(request):
    backend = request.param
    gj = jg.from_edges(EDGES, 52)
    gt = tg.from_edges(EDGES, 52, device="cpu")
    lms = jg.select_landmarks(gj, 5)
    sj = j_build(gj, lms)
    st = t_build(gt, lms, device="cpu")
    kw = {"n_hubs": 12} if backend == "hybrid" else {}
    pallas = {"use_pallas": True, "interpret": True} if backend == "hybrid" else {}
    ctx_j = js.make_search_context(gj, sj, backend=backend, **kw, **pallas)
    ctx_t = ts.make_search_context(gt, st, backend=backend, **kw)
    rng = np.random.default_rng(11)
    us = np.concatenate([rng.integers(0, 52, 20), [3, lms[0], lms[1], 45, 7]])
    vs = np.concatenate([rng.integers(0, 52, 20), [3, 9, lms[2], 2, 48]])
    us, vs = us.astype(np.int32), vs.astype(np.int32)
    skj = j_sketch(ctx_j.label_dist[us], ctx_j.label_dist[vs], ctx_j.meta_w,
                   js.pack_labelling(sj).meta_dist, use_pallas=True)
    qj = js.Query(u=jnp.asarray(us), v=jnp.asarray(vs), d_top=skj.d_top,
                  du_land=skj.du_land, dv_land=skj.dv_land,
                  meta_edge=skj.meta_edge, d_star_u=skj.d_star_u,
                  d_star_v=skj.d_star_v)
    packed = ts.pack_labelling(st)
    skt = t_sketch(ctx_t.label_dist[torch.from_numpy(us).long()],
                   ctx_t.label_dist[torch.from_numpy(vs).long()], ctx_t.meta_w,
                   packed.meta_dist)
    qt = ts.Query(u=torch.from_numpy(us), v=torch.from_numpy(vs), d_top=skt.d_top,
                  du_land=skt.du_land, dv_land=skt.dv_land,
                  meta_edge=skt.meta_edge, d_star_u=skt.d_star_u,
                  d_star_v=skt.d_star_v)
    for a, b in zip(qj, qt):
        assert np.array_equal(np.asarray(a), b.numpy())
    return gj.n_vertices, ctx_j, ctx_t, qj, qt


def _eq(a, b):
    assert np.array_equal(np.asarray(a), b.numpy())


def test_bidirectional_bfs(setup):
    v, ctx_j, ctx_t, qj, qt = setup
    want = jax.vmap(lambda q: js.bidirectional_bfs(ctx_j, q, v, MAX_LEVELS))(qj)
    got = ts.bidirectional_bfs(ctx_t, qt, v, MAX_LEVELS)
    for a, b in zip(want, got):
        _eq(a, b)


def test_reverse_and_recover_stages(setup):
    v, ctx_j, ctx_t, qj, qt = setup
    du, dv = ts.bidirectional_bfs(ctx_t, qt, v, MAX_LEVELS)[:2]
    common = (du < INF) & (dv < INF)
    d_minus = torch.where(common, du + dv, INF).amin(dim=1)
    du_j, dv_j, dm_j = (jnp.asarray(x.numpy()) for x in (du, dv, d_minus))

    _eq(jax.vmap(lambda a, b, c: js.reverse_search(ctx_j, a, b, c, v))(
        du_j, dv_j, dm_j), ts.reverse_search(ctx_t, du, dv, d_minus))

    for depth, depth_j, land, land_j in ((du, du_j, qt.du_land, qj.du_land),
                                         (dv, dv_j, qt.dv_land, qj.dv_land)):
        e_j, on_j = jax.vmap(lambda d, s: js._side_attach(ctx_j, d, s, v, MAX_CHAIN))(
            depth_j, land_j)
        e_t, on_t = ts._side_attach(ctx_t, depth, land, v, MAX_CHAIN)
        _eq(e_j, e_t)
        _eq(on_j, unpack_on(on_t, depth.shape[0]).permute(1, 2, 0))

    _eq(jax.vmap(lambda m: js._delta_edges(ctx_j, m, v))(qj.meta_edge),
        ts._delta_edges(ctx_t, qt.meta_edge))


@pytest.mark.parametrize("max_chain", [1, MAX_CHAIN])
def test_guided_search(setup, max_chain):
    v, ctx_j, ctx_t, qj, qt = setup
    want = jax.vmap(lambda q: js.guided_search(ctx_j, q, v, MAX_LEVELS, max_chain))(qj)
    got = ts.guided_search(ctx_t, qt, v, MAX_LEVELS, max_chain)
    for f in want._fields:
        _eq(getattr(want, f), getattr(got, f))
