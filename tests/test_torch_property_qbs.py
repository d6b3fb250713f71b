"""The hypothesis properties of ``tests/test_property_qbs.py`` on the port's
``QbSIndex`` (``repro_torch`` on the CPU): every SPG equals the two-BFS
oracle (the port's ``bfs_spg``) and the reference index's answer on the
same padded graph and landmarks; every returned edge lies on a shortest
path; the labelling is deterministic under a landmark permutation and
equal to the reference's.  Graphs are padded to fixed (V, E) buckets as in
the reference harness; the example budgets scale with
``QBS_PROPERTY_EXAMPLES_SCALE``.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import QbSIndex as JIndex  # noqa: E402
from repro.core import build_labelling as j_build_labelling  # noqa: E402
from repro.core import from_edges as j_from_edges  # noqa: E402
from repro_torch.core import INF, QbSIndex, build_labelling, from_edges  # noqa: E402
from repro_torch.core import select_landmarks  # noqa: E402
from repro_torch.core.baselines import bfs_distances, bfs_spg  # noqa: E402

V_BUCKET = 48
E_BUCKET = 512  # directed slots
_SCALE = max(1, int(os.environ.get("QBS_PROPERTY_EXAMPLES_SCALE", "1")))


@st.composite
def padded_graphs(draw):
    """(port graph, edges, n, seed): the reference harness's draw."""
    n = draw(st.integers(min_value=6, max_value=V_BUCKET - 1))
    m = draw(st.integers(min_value=n // 2, max_value=min(3 * n, E_BUCKET // 2 - 4)))
    seed = draw(st.integers(min_value=0, max_value=2**31 - 1))
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, size=(m, 2))
    g = from_edges(edges, n, pad_vertices_to=V_BUCKET, pad_edges_to=E_BUCKET,
                   device="cpu")
    return g, edges, n, seed


def _top_degree(g, n, k):
    deg = np.asarray(g.degrees())[:n]
    return np.sort(np.argsort(-deg)[:k]).astype(np.int32)


@given(padded_graphs(), st.integers(0, 3))
@settings(max_examples=25 * _SCALE, deadline=None)
def test_qbs_spg_equals_oracle(gn, nl_choice):
    g, edges, n, seed = gn
    rng = np.random.default_rng(seed ^ 0xABCD)
    nl = [1, 2, 4, 6][nl_choice]
    landmarks = _top_degree(g, n, nl)
    idx = QbSIndex.build(g, landmarks=landmarks, device="cpu")
    jg = j_from_edges(edges, n, pad_vertices_to=V_BUCKET, pad_edges_to=E_BUCKET)
    jidx = JIndex.build(jg, landmarks=landmarks)
    for _ in range(3):
        u = int(rng.integers(0, n))
        v = int(rng.integers(0, n))
        o = bfs_spg(g, u, v, device="cpu")
        r = idx.query(u, v)
        assert r.dist == o.dist, (u, v, r.dist, o.dist)
        assert r.edge_pairs(g) == o.edge_pairs(g), (u, v)
        j = jidx.query(u, v)
        assert (r.dist, r.d_top) == (j.dist, j.d_top), (u, v)
        assert np.array_equal(r.edge_ids, np.asarray(j.edge_ids)), (u, v)


@given(padded_graphs())
@settings(max_examples=15 * _SCALE, deadline=None)
def test_spg_structural_invariants(gn):
    """Every returned SPG is a union of shortest paths: each edge lies on a
    shortest u-v path; u and v are in the vertex set when connected."""
    g, _, n, seed = gn
    rng = np.random.default_rng(seed ^ 0x1234)
    idx = QbSIndex.build(g, landmarks=_top_degree(g, n, 3), device="cpu")
    u = int(rng.integers(0, n))
    v = int(rng.integers(0, n))
    r = idx.query(u, v)
    if r.dist >= INF:
        assert r.edge_ids.size == 0
        return
    if r.dist == 0:
        return
    du = bfs_distances(g, u, device="cpu")
    dv = bfs_distances(g, v, device="cpu")
    verts = r.vertices(g)
    assert u in verts and v in verts
    for a, b in r.edge_pairs(g):
        on = (du[a] + 1 + dv[b] == r.dist) or (du[b] + 1 + dv[a] == r.dist)
        assert on, (a, b, r.dist, du[a], dv[a], du[b], dv[b])


@given(st.integers(0, 2**31 - 1), st.integers(2, 6))
@settings(max_examples=10 * _SCALE, deadline=None)
def test_labelling_deterministic_under_permutation(seed, nl):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, V_BUCKET - 1, size=(60, 2))
    g = from_edges(edges, V_BUCKET - 1, pad_vertices_to=V_BUCKET, pad_edges_to=E_BUCKET,
                   device="cpu")
    landmarks = select_landmarks(g, nl)
    perm = rng.permutation(nl)
    s1 = build_labelling(g, landmarks, device="cpu")
    s2 = build_labelling(g, np.asarray(landmarks)[perm], device="cpu")
    assert (np.asarray(s1.label_dist)[:, perm] == np.asarray(s2.label_dist)).all()
    jg = j_from_edges(edges, V_BUCKET - 1, pad_vertices_to=V_BUCKET, pad_edges_to=E_BUCKET)
    js = j_build_labelling(jg, landmarks)
    assert np.array_equal(np.asarray(s1.label_dist), np.asarray(js.label_dist))
    assert np.array_equal(np.asarray(s1.meta_dist), np.asarray(js.meta_dist))
