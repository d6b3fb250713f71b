"""Port vs reference: epoch-versioned edge updates (DESIGN.md §13).

``edge_keys``, ``apply_edge_updates`` (edge-slot ids and the capacity
doubling), ``affected_landmarks``, ``update_labelling`` (incremental,
no-op and churn-rebuild batches), ``patch_packed`` (including the uint8 ->
uint16 repack and back) and ``QbSIndex.apply_update`` must equal both the
JAX package's results and a fresh port build on the new graph.  The source
index's tensors must be unchanged byte for byte after an update (PyTorch
writes in place, so the update path clones what it patches).  The serving
layer pins epochs: a chunk in flight resolves under its admission epoch, a
stale cache entry is never served, and a deterministic trace of submits,
clock steps and updates answers every future as the per-epoch numpy oracle
does.  Zero tolerance.
"""
import numpy as np
import pytest
import torch

from helpers.serving_oracle import EpochOracle, oracle_spg

from repro.core import QbSIndex as JIndex
from repro.core import graph as jg
from repro.core.labelling import update_labelling as j_update_labelling
from repro.core.packing import patch_packed as j_patch_packed
from repro_torch.convert import index_from_numpy
from repro_torch.core import QbSIndex as TIndex
from repro_torch.core import graph as tg
from repro_torch.core.labelling import affected_landmarks as t_affected
from repro_torch.core.labelling import update_labelling as t_update_labelling
from repro_torch.core.packing import patch_packed as t_patch_packed
from repro_torch.serving import AdmissionPolicy, ManualClock, QoSClass, StreamingService

V = 48
INF = 1 << 20
ENGINE_OPTS = {"segment": None, "csr": {"block_size": 50}, "hybrid": {"n_hubs": 12}}
SCHEME_FIELDS = ("landmarks", "lid", "is_landmark", "label_dist", "meta_w",
                 "meta_dist")


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _same_graph(gj, gt):
    for f in ("indptr", "src", "dst"):
        assert np.array_equal(_np(getattr(gj, f)), _np(getattr(gt, f))), f


def _same_scheme(sj, st):
    for f in SCHEME_FIELDS:
        a, b = _np(getattr(sj, f)), _np(getattr(st, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def _same_packed(pj, pt):
    for a, b in zip(pj, pt):
        assert (a is None) == (b is None)
        if a is not None:
            assert _np(a).dtype == _np(b).dtype and np.array_equal(_np(a), _np(b))


def _same_index(a, b, us, vs):
    """Two indexes serve the same tables and answers (either package)."""
    _same_graph(a.graph, b.graph)
    _same_scheme(a.scheme, b.scheme)
    assert np.array_equal(a._lm_dist_host, b._lm_dist_host)
    _same_packed(a.packed, b.packed)
    da, ma = a.query_batch_arrays(us, vs)
    db, mb = b.query_batch_arrays(us, vs)
    assert np.array_equal(da, db) and np.array_equal(ma, mb)


@pytest.fixture(scope="module")
def jgraph():
    return jg.gnp_random_graph(V, 3.0, seed=7)


@pytest.fixture(scope="module")
def jindex(jgraph):
    return JIndex.build(jgraph, n_landmarks=5, chunk=8)


def _tindex(backend="segment", graph=None, **kw):
    g = tg.gnp_random_graph(V, 3.0, seed=7, device="cpu") if graph is None else graph
    return TIndex.build(g, chunk=8, backend=backend,
                        engine_opts=ENGINE_OPTS[backend], device="cpu",
                        **({"n_landmarks": 5} | kw))


@pytest.fixture(scope="module")
def tindex():
    return _tindex()


def _edges(graph):
    return {tuple(int(x) for x in e) for e in jg.edge_set(graph)}


def _two_path_closers(graph, k, rng):
    """k absent edges (u, x) that close a 2-path u - w - x, one per w."""
    es = _edges(graph)
    adj = {}
    for a, b in es:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, []).append(a)
    out = []
    for w in rng.permutation(sorted(adj)).tolist():
        nb = sorted(adj[w])
        pair = next(((u, x) for i, u in enumerate(nb) for x in nb[i + 1:]
                     if (u, x) not in es and (u, x) not in out), None)
        if pair is not None:
            out.append(pair)
        if len(out) == k:
            return out
    raise AssertionError("no 2-path to close")


def _batch(graph, kind, rng):
    """Effective (inserts, deletes) of a named kind, as (M, 2) int64."""
    es = sorted(_edges(graph))
    pick = lambda n: [es[i] for i in rng.choice(len(es), n, replace=False)]  # noqa: E731
    if kind == "close_two_paths":
        ins, dels = _two_path_closers(graph, 2, rng), pick(2)
    elif kind == "deletes":
        ins, dels = [], pick(3)
    elif kind == "random_inserts":
        absent = [(a, b) for a in range(V) for b in range(a + 1, V)
                  if (a, b) not in set(es)]
        ins, dels = [absent[i] for i in rng.choice(len(absent), 3, replace=False)], []
    else:                                     # "none"
        ins, dels = [], []
    as_arr = lambda x: np.asarray(x, np.int64).reshape(-1, 2)  # noqa: E731
    return as_arr(ins), as_arr(dels)


# ---------------------------------------------------------------- the graph


def test_edge_keys_match_reference():
    rng = np.random.default_rng(0)
    e = rng.integers(0, 30, size=(40, 2))
    assert np.array_equal(tg.edge_keys(e, 30), jg.edge_keys(e, 30))
    assert tg.edge_keys(np.zeros((0, 2)), 30).size == 0
    with pytest.raises(ValueError, match="out of range"):
        tg.edge_keys(np.array([[0, 30]]), 30)
    table = tg.edge_keys(e, 30)
    probe = np.concatenate([table[::3], table + 1, [-5, 10**6], table[-1:]])
    assert np.array_equal(tg.in_sorted(probe, table), np.isin(probe, table))
    assert not tg.in_sorted(probe, table[:0]).any()


@pytest.mark.parametrize("kind", ["balanced", "net_insert_doubles", "deletes",
                                  "noop", "insert_wins_tie"])
def test_apply_edge_updates_matches_reference(jgraph, kind):
    tgraph = tg.gnp_random_graph(V, 3.0, seed=7, device="cpu")
    rng = np.random.default_rng(1)
    es = sorted(_edges(jgraph))
    absent = [(a, b) for a in range(V) for b in range(a + 1, V)
              if (a, b) not in set(es)]
    ins = [absent[i] for i in rng.choice(len(absent), 4, replace=False)]
    dels = [es[i] for i in rng.choice(len(es), 4, replace=False)]
    args = {"balanced": (ins, dels), "net_insert_doubles": (ins + absent[-60:], None),
            "deletes": (None, dels), "noop": (None, None),
            "insert_wins_tie": (ins, ins[:2] + dels)}[kind]
    gj = jg.apply_edge_updates(jgraph, *args)
    gt = tg.apply_edge_updates(tgraph, *args)
    _same_graph(gj, gt)
    assert gt.n_edges == gj.n_edges
    assert (gt.n_edges == 2 * tgraph.n_edges) == (kind == "net_insert_doubles")
    assert gt.device == tgraph.device


# ------------------------------------------------------------ the labelling


@pytest.mark.parametrize("backend", ["segment", "csr", "hybrid"])
@pytest.mark.parametrize("kind", ["close_two_paths", "deletes", "random_inserts",
                                  "none"])
def test_update_labelling_matches_reference_and_fresh_build(jgraph, jindex, kind,
                                                            backend):
    rng = np.random.default_rng(len(kind))
    ins, dels = _batch(jgraph, kind, rng)
    tidx = _tindex(backend)
    gj = jg.apply_edge_updates(jgraph, ins, dels)
    gt = tg.apply_edge_updates(tidx.graph, ins, dels)
    lm = jindex._lm_dist_host
    assert np.array_equal(tidx._lm_dist_host, lm)
    aff_t = t_affected(tidx.scheme, lm, gt, ins, dels)
    sj, lj, ij = j_update_labelling(gj, jindex.scheme, lm, ins, dels,
                                    churn_threshold=1.1)
    st, lt, it = t_update_labelling(gt, tidx.scheme, lm, ins, dels,
                                    backend=backend, churn_threshold=1.1,
                                    **(ENGINE_OPTS[backend] or {}))
    assert np.array_equal(np.flatnonzero(aff_t), ij["affected"])
    assert np.array_equal(it["affected"], ij["affected"])
    assert (it["n_affected"], it["full_rebuild"]) == (ij["n_affected"], False)
    assert (it["n_affected"] == 0) == (kind == "none")
    _same_scheme(sj, st)
    assert np.array_equal(lj, lt)
    fresh = _tindex(backend, graph=gt, landmarks=_np(tidx.scheme.landmarks))
    _same_scheme(fresh.scheme, st)
    assert np.array_equal(fresh._lm_dist_host, lt)
    packed = t_patch_packed(tidx.packed, st, lt, it["affected"]) \
        if it["n_affected"] else tidx.packed
    _same_packed(j_patch_packed(jindex.packed, sj, lj, ij["affected"])
                 if ij["n_affected"] else jindex.packed, packed)
    _same_packed(fresh.packed, packed)


def test_churn_threshold_asks_for_a_rebuild(jgraph, jindex, tindex):
    rng = np.random.default_rng(2)
    ins, dels = _batch(jgraph, "random_inserts", rng)
    gj = jg.apply_edge_updates(jgraph, ins, dels)
    gt = tg.apply_edge_updates(tindex.graph, ins, dels)
    got = t_update_labelling(gt, tindex.scheme, tindex._lm_dist_host, ins, dels,
                             churn_threshold=0.0)
    want = j_update_labelling(gj, jindex.scheme, jindex._lm_dist_host, ins, dels,
                              churn_threshold=0.0)
    assert got[:2] == (None, None) and want[:2] == (None, None)
    assert got[2]["full_rebuild"] and np.array_equal(got[2]["affected"],
                                                     want[2]["affected"])


def _shortcut_path(n: int, mid: int):
    """An n-vertex path with a shortcut (0, mid): with landmarks 0 and mid
    (the two degree-3 vertices) every distance stays below 255."""
    edges = [(i, i + 1) for i in range(n - 1)] + [(0, mid)]
    return np.asarray(edges, np.int64)


def _path_indexes(n, mid):
    edges = _shortcut_path(n, mid)
    lms = np.array([0, mid], np.int32)
    return (JIndex.build(jg.from_edges(edges, n), landmarks=lms, chunk=8),
            TIndex.build(tg.from_edges(edges, n, device="cpu"), landmarks=lms,
                         chunk=8, device="cpu"), lms)


def test_patch_packed_repacks_uint8_to_uint16_and_back():
    """Cutting the shortcut of a 257-vertex path takes landmark 0's farthest
    vertex to distance 256, past the uint8 sentinel (a full repack to
    uint16); putting it back narrows to uint8 again.  Each epoch equals the
    reference's and a fresh build."""
    n, mid = 257, 128
    cur_j, cur_t, lms = _path_indexes(n, mid)
    us = np.array([0, n - 1, 5, mid + 1, 10], np.int32)
    vs = np.array([n - 1, mid, n - 9, mid - 1, 0], np.int32)
    dtypes = []
    for ev in ({"deletes": [(0, mid)]}, {"inserts": [(0, mid)]},
               {"inserts": [(10, 20)]}, {"deletes": [(10, 20)]},
               {"deletes": [(0, mid)]}, {"inserts": [(200, 202)]}):
        cur_j = cur_j.apply_update(**ev, churn_threshold=1.1)
        cur_t = cur_t.apply_update(**ev, churn_threshold=1.1)
        assert not cur_t.last_update_info["full_rebuild"]
        assert cur_t.last_update_info["n_affected"] > 0
        _same_index(cur_j, cur_t, us, vs)
        assert cur_t.epoch == cur_j.epoch
        fresh = TIndex.build(cur_t.graph, landmarks=lms, chunk=8, device="cpu")
        _same_index(fresh, cur_t, us, vs)
        dtypes.append(str(cur_t.packed.dtype))
    # the last update patches uint16 tables in place of a repack
    assert dtypes == ["uint16", "uint8", "uint8", "uint8", "uint16", "uint16"]


def test_update_past_max_levels_matches_reference():
    """On a 300-vertex path the cut leaves landmark 0's far end 299 hops away,
    past the labelling's 256 BFS levels: the recomputed row stops there, in
    the reference as in the port (a fresh build, which reaches those
    vertices through the other landmark's labels, differs; see ROADMAP)."""
    cur_j, cur_t, _ = _path_indexes(300, 150)
    us = np.array([0, 299, 5, 151], np.int32)
    vs = np.array([299, 150, 290, 149], np.int32)
    for ev in ({"deletes": [(0, 150)]}, {"inserts": [(0, 150)]}):
        cur_j = cur_j.apply_update(**ev, churn_threshold=1.1)
        cur_t = cur_t.apply_update(**ev, churn_threshold=1.1)
        _same_index(cur_j, cur_t, us, vs)


# ------------------------------------------------------------ apply_update


@pytest.mark.parametrize("backend", ["segment", "csr", "hybrid"])
def test_apply_update_chain_matches_reference_and_fresh_build(jgraph, backend):
    """Six alternating single-edge updates: each epoch of the port equals the
    reference's epoch and a fresh port build with the same landmarks."""
    rng = np.random.default_rng(3)
    cur_j = JIndex.build(jgraph, n_landmarks=5, chunk=8)
    cur_t = _tindex(backend)
    lms = _np(cur_t.scheme.landmarks)
    us = rng.integers(0, V, 12).astype(np.int32)
    vs = rng.integers(0, V, 12).astype(np.int32)
    present = set(_edges(jgraph))
    for i in range(6):
        if i % 2 == 0:
            while True:
                a, b = sorted(int(x) for x in rng.integers(0, V, 2))
                if a != b and (a, b) not in present:
                    break
            present.add((a, b))
            ev = {"inserts": [(a, b)]}
        else:
            e = sorted(present)[int(rng.integers(len(present)))]
            present.discard(e)
            ev = {"deletes": [e]}
        cur_j = cur_j.apply_update(**ev, churn_threshold=1.1)
        cur_t = cur_t.apply_update(**ev, churn_threshold=1.1)
        assert cur_t.epoch == i + 1
        assert cur_t.last_update_info["n_affected"] == \
            cur_j.last_update_info["n_affected"]
        _same_index(cur_j, cur_t, us, vs)
        fresh = _tindex(backend, graph=cur_t.graph, landmarks=lms)
        _same_scheme(fresh.scheme, cur_t.scheme)
        _same_packed(fresh.packed, cur_t.packed)
        assert np.array_equal(fresh._lm_dist_host, cur_t._lm_dist_host)


def _snapshot(idx):
    tensors = [*idx.graph, *idx.scheme, *(t for t in idx.packed if t is not None)]
    return [t.clone() for t in tensors], idx._lm_dist_host.copy()


@pytest.mark.parametrize("branch", ["incremental", "rebuild", "noop"])
def test_source_index_unchanged_after_apply_update(jgraph, branch):
    idx = _tindex("hybrid")
    rng = np.random.default_rng(4)
    us = rng.integers(0, V, 10).astype(np.int32)
    vs = rng.integers(0, V, 10).astype(np.int32)
    before_d, before_m = idx.query_batch_arrays(us, vs)
    tensors, lm_host = _snapshot(idx)
    ins, dels = _batch(jgraph, "close_two_paths" if branch != "noop" else "none", rng)
    new = idx.apply_update(inserts=ins, deletes=dels,
                           churn_threshold=0.0 if branch == "rebuild" else 1.1)
    assert new.last_update_info["full_rebuild"] == (branch == "rebuild")
    assert (new.last_update_info["n_affected"] > 0) == (branch != "noop")
    now = [*idx.graph, *idx.scheme, *(t for t in idx.packed if t is not None)]
    for a, b in zip(tensors, now):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    assert np.array_equal(lm_host, idx._lm_dist_host)
    assert idx.epoch == 0 and idx.last_update_info == {}
    d, m = idx.query_batch_arrays(us, vs)
    assert np.array_equal(d, before_d) and np.array_equal(m, before_m)


def test_convert_carries_epoch_and_lm_dist(jgraph, jindex, tindex):
    """A reference index at epoch 1 converts to a port index at epoch 1, which
    then updates exactly as the reference's does."""
    ev = {"deletes": [sorted(_edges(jgraph))[5]]}
    j1 = jindex.apply_update(**ev)
    t1 = index_from_numpy([np.asarray(f) for f in j1.graph],
                          {f: np.asarray(getattr(j1.scheme, f)) for f in SCHEME_FIELDS},
                          device="cpu", chunk=8, epoch=j1.epoch,
                          lm_dist=j1._lm_dist_host)
    rng = np.random.default_rng(6)
    us = rng.integers(0, V, 10).astype(np.int32)
    vs = rng.integers(0, V, 10).astype(np.int32)
    _same_index(j1, t1, us, vs)
    assert t1.epoch == j1.epoch == 1
    _same_index(tindex.apply_update(**ev), t1, us, vs)
    ev2 = {"inserts": [(1, 40), (2, 33)]}
    j2, t2 = j1.apply_update(**ev2), t1.apply_update(**ev2)
    _same_index(j2, t2, us, vs)
    assert t2.epoch == j2.epoch == 2


def test_update_batch_semantics(jgraph, jindex, tindex):
    """Phantom inserts/deletes are no-ops, an insert wins a same-batch tie,
    self-loops are dropped; an all-phantom batch still advances the epoch."""
    es = sorted(_edges(jgraph))
    present = es[0]
    absent = next((a, b) for a in range(V) for b in range(a + 1, V)
                  if (a, b) not in set(es))
    ins, dels = [present, absent, (3, 3)], [absent, present]
    rng = np.random.default_rng(8)
    us = rng.integers(0, V, 10).astype(np.int32)
    vs = rng.integers(0, V, 10).astype(np.int32)
    _same_index(jindex.apply_update(inserts=ins, deletes=dels),
                tindex.apply_update(inserts=ins, deletes=dels), us, vs)
    noop = tindex.apply_update(inserts=[present], deletes=[absent])
    assert noop.epoch == 1 and noop.last_update_info["n_affected"] == 0
    assert noop.packed is tindex.packed
    oracle = EpochOracle(jgraph)
    oracle.advance(tindex.apply_update(inserts=ins, deletes=dels).graph,
                   inserts=ins, deletes=dels)


def test_star_double_delete_and_disconnect():
    """Two deletes sharing an endpoint in one batch; a cut that splits the
    graph and a bridge that joins it again, against the numpy oracle."""
    edges = np.array([[0, 1], [0, 2], [1, 3], [2, 3], [3, 4]])
    lms = np.array([0, 3])
    cur = TIndex.build(tg.from_edges(edges, 5, device="cpu"), landmarks=lms,
                       chunk=4, device="cpu")
    ref = JIndex.build(jg.from_edges(edges, 5), landmarks=lms, chunk=4)
    us = np.array([0, 0, 3, 1], np.int32)
    vs = np.array([4, 3, 4, 2], np.int32)
    cur = cur.apply_update(deletes=[(1, 3), (2, 3)])
    ref = ref.apply_update(deletes=[(1, 3), (2, 3)])
    _same_index(ref, cur, us, vs)
    d, _ = cur.query_batch_arrays(us, vs)
    assert d[0] >= INF and d[1] >= INF and d[2] == 1 and d[3] == 2
    cur = cur.apply_update(inserts=[(2, 4)])
    ref = ref.apply_update(inserts=[(2, 4)])
    _same_index(ref, cur, us, vs)
    for u, v in zip(us.tolist(), vs.tolist()):
        od, oe = oracle_spg(cur.graph, u, v)
        r = cur.query(u, v)
        assert r.dist == od and np.array_equal(r.edge_ids, oe)


# ------------------------------------------------------- epoch-pinned serving


def test_inflight_chunks_resolve_under_admission_epoch(jgraph, tindex):
    """Chunks in flight when an update lands resolve from their admission
    epoch's tables; later submissions of the same pairs resolve from the
    new epoch, each checked against its own oracle."""
    st = StreamingService(
        tindex, clock=ManualClock(),
        policy=AdmissionPolicy(adaptive=False, chunk=4, min_chunk=4),
        async_depth=4, cache_size=64)
    rng = np.random.default_rng(11)
    us = rng.integers(0, V, 8).astype(np.int32)
    vs = (us + rng.integers(1, V - 1, 8).astype(np.int32)) % V
    oracle = EpochOracle(tindex.graph)
    futs0 = st.submit_batch(us, vs)           # size trigger: dispatches now
    assert st.n_inflight > 0                  # the window still holds chunks
    ev = {"deletes": [sorted(_edges(jgraph))[3]]}
    new = st.submit_update(**ev)
    oracle.advance(new.graph, **ev)
    assert st.index.epoch == 1 and st.stats["updates"] == 1
    futs1 = st.submit_batch(us, vs)           # must not join the old flight
    st.drain()
    assert not st._flight and not st._waiting
    assert {f.epoch for f in futs0} == {0} and {f.epoch for f in futs1} == {1}
    for f in futs0 + futs1:
        oracle.assert_future(f)
    st.close()


def test_stale_cache_entry_never_served_across_epochs(jgraph, tindex):
    rng = np.random.default_rng(13)
    st = StreamingService(tindex, clock=ManualClock(), cache_size=64,
                          policy=AdmissionPolicy(adaptive=False, chunk=64))
    u = v = cut = None
    for _ in range(50):
        a, b = (int(x) for x in rng.integers(0, V, 2))
        d, eids = oracle_spg(jgraph, a, b)
        if 2 <= d < INF:
            u, v = a, b
            cut = (int(np.asarray(jgraph.src)[eids[0]]),
                   int(np.asarray(jgraph.dst)[eids[0]]))
            break
    assert u is not None
    st.submit(u, v)
    st.drain()
    key = (min(u, v), max(u, v))
    assert (key[0], key[1], 0) in st.service.cache
    hits0 = st.stats["cache_hits"]
    st.submit(u, v)                           # same epoch: a cache hit
    assert st.stats["cache_hits"] == hits0 + 1
    new = st.submit_update(deletes=[cut])
    fut = st.submit(u, v)
    st.drain()
    assert st.stats["cache_hits"] == hits0 + 1     # the stale entry unused
    assert (key[0], key[1], 0) in st.service.cache
    d1, e1 = oracle_spg(new.graph, u, v)
    assert fut.epoch == 1 and fut.result().dist == d1
    assert np.array_equal(fut.result().edge_ids, e1)
    st.close()


@pytest.mark.parametrize("seed", [0, 1])
def test_trace_sweep_against_epoch_oracle(tindex, seed):
    """A deterministic trace of submits under two classes, clock steps,
    polls, single-edge updates and drains: every future equals the numpy
    oracle at the epoch it resolved under."""
    rng = np.random.default_rng(100 + seed)
    clock = ManualClock()
    st = StreamingService(
        tindex, clock=clock, cache_size=32, cache_policy="hub",
        qos=(QoSClass("interactive", max_wait=0.002, weight=3.0),
             QoSClass("batch", max_wait=0.05)),
        policy=AdmissionPolicy(min_chunk=2, max_chunk=16), async_depth=3)
    oracle = EpochOracle(tindex.graph)
    futs = []
    for step in range(24):
        r = rng.random()
        if r < 0.6:
            n = int(rng.integers(1, 7))
            us = rng.integers(0, V, n)
            vs = rng.integers(0, V, n)
            futs += st.submit_batch(us, vs, qos=("interactive", "batch")[step % 2])
        elif r < 0.75:
            es = sorted(_edges(st.index.graph))
            if rng.random() < 0.5:
                ev = {"deletes": [es[int(rng.integers(len(es)))]]}
            else:
                a, b = sorted(int(x) for x in rng.choice(V, 2, replace=False))
                ev = {"inserts": [(a, b)]}
            new = st.submit_update(**ev)
            oracle.advance(new.graph, **ev)
        elif r < 0.9:
            clock.advance(float(rng.choice([0.001, 0.003, 0.06])))
        else:
            st.drain()
    st.drain()
    assert st.stats["updates"] > 0 and len({f.epoch for f in futs}) > 1
    for f in futs:
        oracle.assert_future(f)
    st.close()
