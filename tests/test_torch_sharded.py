"""Port vs reference: the vertex-sharded ``ShardedIndex`` (every lane from
the born-sharded tables, served directly and through ``StreamingService``)
and ``scale_serve``, on ``Mesh(["cpu"] * S)`` for S in {1, 2, 3, 4, 8}.

The oracle is the single-device index: the reference's
``repro.core.QbSIndex.query_batch_arrays`` / ``query_batch`` and the port's
``QbSIndex`` on all three relay backends (the reference's own sharded
serving needs a multi-device JAX mesh, which this process cannot make).
``scale_serve`` is also held against the reference's at S = 1.  The batches
cover the general, landmark-pair, one-sided and trivial lanes.  Every
comparison is exact, with zero tolerance: distances are int32, SPGs
boolean edge masks and edge-id arrays.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

from repro.core import QbSIndex as JIndex  # noqa: E402
from repro.core import graph as jg  # noqa: E402
from repro.core.labelling import build_labelling as j_build_labelling  # noqa: E402
from repro.core.scale_serve import scale_serve as j_scale_serve  # noqa: E402
from repro_torch.core import QbSIndex as TIndex  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core.mesh import Mesh  # noqa: E402
from repro_torch.core.qbs import _reverse_edge_map  # noqa: E402
from repro_torch.core.scale_serve import scale_serve  # noqa: E402
from repro_torch.core.sharded import ShardedIndex  # noqa: E402
from repro_torch.core import sharded  # noqa: E402
from repro_torch.serving import AdmissionPolicy, ManualClock  # noqa: E402

PATH_EDGES = np.stack([np.arange(299), np.arange(1, 300)], axis=1)

GRAPHS = {
    "gnp": (lambda m, **kw: m.gnp_random_graph(60, 3.5, seed=42, **kw), 5),
    "grid": (lambda m, **kw: m.grid_graph(7, 7, **kw), 4),
    "ba": (lambda m, **kw: m.barabasi_albert_graph(1000, 3, seed=0, **kw), 10),
}
SHARDS = [1, 2, 3, 4, 8]
BACKENDS = {"segment": None, "csr": {"block_size": 100}, "hybrid": {"n_hubs": 16}}


def _queries(n, lms, is_lm, seed=0, n_q=40):
    """Random pairs plus every landmark lane, a trivial pair and a repeat."""
    rng = np.random.default_rng(seed)
    us = rng.integers(0, n, n_q).astype(np.int32)
    vs = rng.integers(0, n, n_q).astype(np.int32)
    non = np.flatnonzero(~is_lm)
    us[:3], vs[:3] = lms[:3], lms[1:4]          # landmark pairs
    us[3:6], vs[3:6] = non[:3], lms[:3]         # one-sided, both orientations
    us[6:8], vs[6:8] = lms[2:4], non[3:5]
    us[8], vs[8] = non[5], non[5]               # trivial
    us[9], vs[9] = vs[10], us[10]               # a reversed pair
    return us, vs


@pytest.fixture(scope="module")
def reference():
    """Per graph: both packages' single-device indexes, the queries and the
    reference's answers (arrays, and edge ids through ``query_batch``)."""
    out = {}
    for name, (gen, nl) in GRAPHS.items():
        gj, gt = gen(jg), gen(tg, device="cpu")
        idx_j = JIndex.build(gj, n_landmarks=nl, use_pallas=False)
        lms = np.asarray(idx_j.scheme.landmarks)
        us, vs = _queries(gj.n_vertices, lms, np.asarray(idx_j.scheme.is_landmark))
        d_j, m_j = idx_j.query_batch_arrays(us, vs)
        res_j = idx_j.query_batch(us, vs)
        out[name] = dict(gj=gj, gt=gt, lms=lms, us=us, vs=vs,
                         d=np.asarray(d_j), m=np.asarray(m_j), res=res_j,
                         idx_j=idx_j)
    return out


def _port_index(ref, backend="segment", **kw):
    return TIndex.build(ref["gt"], landmarks=ref["lms"], backend=backend,
                        engine_opts=BACKENDS[backend], device="cpu", **kw)


def _same_results(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.u, a.v, a.dist, a.d_top) == (b.u, b.v, b.dist, b.d_top)
        assert np.array_equal(a.edge_ids, np.asarray(b.edge_ids))


# -- the vertex-sharded index ------------------------------------------------


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_sharded_index_matches_single_device(reference, name, s):
    ref = reference[name]
    sh = ShardedIndex.build(ref["gt"], landmarks=ref["lms"], mesh=Mesh(["cpu"] * s))
    assert sh.is_sharded and sh.mesh.n_shards == s and len(sh.labels.labels_sh) == s
    d, m = sh.query_batch_arrays(ref["us"], ref["vs"])
    assert d.dtype == np.int32 and m.dtype == bool
    assert np.array_equal(d, ref["d"])
    assert np.array_equal(m, ref["m"])
    rev = _reverse_edge_map(ref["gt"].src, ref["gt"].dst, ref["gt"].n_vertices)
    assert (m == m[:, rev.numpy()]).all()                   # symmetrized
    _same_results(sh.query_batch(ref["us"], ref["vs"]), ref["res"])


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_sharded_index_matches_port_backends(reference, backend):
    ref = reference["gnp"]
    got = ShardedIndex.build(ref["gt"], landmarks=ref["lms"], mesh=Mesh(["cpu"] * 3),
                             chunk=8).query_batch(ref["us"], ref["vs"])
    want = _port_index(ref, backend, chunk=8).query_batch(ref["us"], ref["vs"])
    _same_results(got, want)


@pytest.mark.parametrize("s", [1, 3])
def test_sharded_index_uint16_tables(s):
    """Labels past 255 pack to uint16; the shards' rows travel as int16."""
    gj = jg.from_edges(PATH_EDGES, 300)
    gt = tg.from_edges(PATH_EDGES, 300, device="cpu")
    lms = np.array([0, 299], np.int32)
    sh = ShardedIndex.build(gt, landmarks=lms, mesh=Mesh(["cpu"] * s),
                            build_max_levels=400, max_levels=400, max_chain=400)
    assert sh.labels.pack_dtype == np.uint16
    us = np.array([0, 10, 150, 299, 42, 7, 3], np.int32)
    vs = np.array([299, 290, 150, 0, 257, 298, 0], np.int32)
    want = JIndex(gj, j_build_labelling(gj, lms, max_levels=400),
                  use_pallas=False, max_levels=400, max_chain=400)
    d, m = sh.query_batch_arrays(us, vs)
    d_j, m_j = want.query_batch_arrays(us, vs)
    assert np.array_equal(d, np.asarray(d_j)) and np.array_equal(m, np.asarray(m_j))


def test_qbs_build_sharded_returns_sharded_index(reference):
    ref = reference["gnp"]
    idx = TIndex.build(ref["gt"], landmarks=ref["lms"], sharded=Mesh(["cpu"] * 2),
                       chunk=8)
    assert isinstance(idx, ShardedIndex) and idx.is_sharded and idx.chunk == 8
    a, b = idx.query(1, 17), _port_index(ref).query(1, 17)
    assert a.dist == b.dist and np.array_equal(a.edge_ids, b.edge_ids)
    assert not _port_index(ref).is_sharded
    with pytest.raises(ValueError, match="sharded="):
        TIndex.build(ref["gt"], landmarks=ref["lms"], sharded=Mesh(["cpu"]),
                     device="cpu")


def test_service_refuses_to_install_a_sharded_index(reference):
    ref = reference["gnp"]
    sh = ShardedIndex.build(ref["gt"], landmarks=ref["lms"], mesh=Mesh(["cpu"]))
    svc = _port_index(ref).make_service()
    with pytest.raises(ValueError, match="sharded index"):
        svc.install_index(sh)


POLICIES = {"default": None, "2-16": AdmissionPolicy(min_chunk=2, max_chunk=16)}


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("s", SHARDS)
def test_sharded_index_streams_bit_identical(reference, s, policy):
    """``StreamingService`` over a ``ShardedIndex``: a lone query, then three,
    then the rest, each drained, so the adaptive width walks down to the
    policy's smallest and back up (powers of two: three shards divide none
    of them, eight not the smallest); every answer equals the one-device
    reference's."""
    ref = reference["gnp"]
    sh = ShardedIndex.build(ref["gt"], landmarks=ref["lms"], mesh=Mesh(["cpu"] * s),
                            chunk=8)
    st = sh.make_stream(policy=POLICIES[policy], clock=ManualClock())
    futs = []
    for a, b in ((0, 1), (1, 4), (4, len(ref["us"]))):
        futs += st.submit_batch(ref["us"][a:b], ref["vs"][a:b])
        st.drain()
    _same_results([f.result() for f in futs], ref["res"])
    widths = {e["chunk"] for e in st.admission_log}
    assert min(widths) == st.policy.min_chunk and max(widths) > min(widths)
    st.close()


@pytest.mark.parametrize("s", SHARDS)
def test_attach_plan_is_made_once_per_build(reference, monkeypatch, s):
    """The shard record, and with it the attach's plan, is made when the
    index is built; chunks of every lane read it and make none."""
    ref = reference["gnp"]
    plans, chunks = [], []
    make_plan, lane = sharded.make_attach_plan, sharded.general_lane
    monkeypatch.setattr(sharded, "make_attach_plan",
                        lambda *a: plans.append(make_plan(*a)) or plans[-1])
    monkeypatch.setattr(sharded, "general_lane",
                        lambda rec, *a: chunks.append(rec) or lane(rec, *a))
    sh = ShardedIndex.build(ref["gt"], landmarks=ref["lms"], mesh=Mesh(["cpu"] * s),
                            chunk=8)
    assert len(plans) == 1 and sh.record.attach_plan is plans[0]
    _same_results(sh.query_batch(ref["us"], ref["vs"]), ref["res"])
    assert len(chunks) >= 2 and all(rec is sh.record for rec in chunks)
    assert len(plans) == 1


@pytest.mark.parametrize("name", ["gnp", "grid"])
def test_sharded_size_accounting(reference, name):
    ref = reference[name]
    g = ref["gt"]
    one = ShardedIndex.build(g, landmarks=ref["lms"], mesh=Mesh(["cpu"]))
    info = one.sharded_size_bytes()
    item = one.labels.pack_dtype.itemsize
    v, r = g.n_vertices, one.labels.n_landmarks
    assert info["n_shards"] == 1
    assert info["per_device_label_bytes"] == one.labels.per_device_label_bytes() \
        == 2 * one.labels.v_loc * r * item + 2 * r * r * item
    assert info["per_device_csr_bytes"] == 4 * one.part.e_max * 4
    assert info["replicated_label_bytes"] == (2 * v * r + 2 * r * r) * item
    assert info["replicated_csr_bytes"] == 3 * g.n_edges * 4
    assert info["per_device_bytes"] == \
        info["per_device_label_bytes"] + info["per_device_csr_bytes"]
    assert info["per_device_frac"] == pytest.approx(
        info["per_device_bytes"] / info["replicated_bytes"])
    # one shard holds the whole label table
    assert info["per_device_label_bytes"] == info["replicated_label_bytes"]
    # eight shards: per-device label + CSR bytes within 1/4 of the replica
    eight = ShardedIndex.build(g, landmarks=ref["lms"], mesh=Mesh(["cpu"] * 8))
    info8 = eight.sharded_size_bytes()
    assert info8["n_shards"] == 8 and info8["per_device_frac"] <= 0.25, info8


# -- scale_serve ---------------------------------------------------------------


def _general_pairs(ref, n=6, seed=1):
    rng = np.random.default_rng(seed)
    non = np.flatnonzero(~np.asarray(ref["idx_j"].scheme.is_landmark))
    return (rng.choice(non, size=n).astype(np.int32),
            rng.choice(non, size=n).astype(np.int32))


@pytest.mark.parametrize("name", ["gnp", "grid"])
def test_scale_serve_one_shard_matches_reference(reference, name):
    ref = reference[name]
    us, vs = _general_pairs(ref)
    mesh = JMesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    pairs_j, dist_j = j_scale_serve(ref["gj"], ref["idx_j"].scheme, mesh, us, vs)
    scheme = _port_index(ref).scheme
    pairs, dist = scale_serve(ref["gt"], scheme, Mesh(["cpu"]), us, vs)
    assert np.array_equal(dist, np.asarray(dist_j))
    assert pairs == pairs_j


@pytest.mark.parametrize("s", SHARDS[1:])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_scale_serve_matches_single_device(reference, name, s):
    ref = reference[name]
    us, vs = _general_pairs(ref, seed=s)
    idx = _port_index(ref)
    pairs, dist = scale_serve(ref["gt"], idx.scheme, Mesh(["cpu"] * s), us, vs)
    for k, r in enumerate(ref["idx_j"].query_batch(us, vs)):
        assert int(dist[k]) == r.dist
        assert pairs[k] == r.edge_pairs(ref["gj"])

