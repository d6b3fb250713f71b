"""Port vs reference: the result cache and the cache-aware serving service.

The same operation sequence goes through ``repro.serving.ResultCache`` and
``repro_torch.serving.ResultCache``: hit/miss/eviction counters, resident
bytes, the packed entries of ``export_packed`` (LRU-to-MRU order and
encodings), protected-tier demotion and ``capacity_bytes`` eviction must be
equal.  Then ``ServingService`` with every cache policy and admission mode
answers the same batches as the reference's service, with equal
``lane_served`` and cache counters.  Zero tolerance throughout.
"""
import numpy as np
import pytest

from repro.core import QbSIndex as JIndex
from repro.core import gnp_random_graph as j_gnp
from repro.serving import ResultCache as JCache
from repro.serving import ServingService as JService
from repro.serving import round_chunk_to_shards as j_round
from repro.serving.service import _pack_result as j_pack
from repro.serving.service import _unpack_result as j_unpack
from repro_torch.core import QbSIndex as TIndex
from repro_torch.core import gnp_random_graph as t_gnp
from repro_torch.serving import ResultCache as TCache
from repro_torch.serving import ServingService as TService
from repro_torch.serving import round_chunk_to_shards as t_round
from repro_torch.serving.service import _pack_result as t_pack
from repro_torch.serving.service import _unpack_result as t_unpack

V = 45


def _same_entry(a, b):
    """Two packed ``(nbytes, dist, enc)`` entries are equal, arrays included."""
    assert a[:2] == b[:2]
    assert a[2][0] == b[2][0]
    for x, y in zip(a[2][1:], b[2][1:]):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        else:
            assert x == y


def _same_export(a, b):
    assert [k for k, _ in a] == [k for k, _ in b]
    for (_, ea), (_, eb) in zip(a, b):
        _same_entry(ea, eb)


def _same_counters(cj, ct):
    assert (cj.hits, cj.misses, cj.evictions, cj.bytes, len(cj)) == \
        (ct.hits, ct.misses, ct.evictions, ct.bytes, len(ct))


def _eids(rng, kind):
    """Sorted edge-id arrays of each encoding: delta (small gaps), raw (a gap
    past uint16), a single id and none."""
    if kind == "delta":
        return np.cumsum(rng.integers(1, 300, size=int(rng.integers(2, 9)))
                         ).astype(np.int32)
    if kind == "raw":
        return np.array([3, 70_000 + int(rng.integers(0, 9))], np.int32)
    if kind == "one":
        return np.array([int(rng.integers(0, 1000))], np.int32)
    return np.zeros((0,), np.int32)


@pytest.mark.parametrize("kind", ["delta", "raw", "one", "none"])
def test_pack_result_matches_reference(kind):
    rng = np.random.default_rng(1)
    for _ in range(5):
        value = (int(rng.integers(0, 9)), _eids(rng, kind))
        pj, pt = j_pack(value), t_pack(value)
        _same_entry(pj, pt)
        dj, ej = j_unpack(pj)
        dt, et = t_unpack(pt)
        assert dj == dt and np.array_equal(ej, et) and et.dtype == np.int32
        # delta entries decode frozen; raw ones hand back the stored array
        assert et.flags.writeable == ej.flags.writeable


CACHE_CONFIGS = {
    "lru": dict(capacity=6),
    "hub": dict(capacity=8, protect=lambda k: k[0] % 3 == 0,
                protected_frac=0.25),
    "bytes": dict(capacity=50, capacity_bytes=60),
    "hub_bytes": dict(capacity=10, protect=lambda k: k[1] % 2 == 0,
                      protected_frac=0.5, capacity_bytes=90),
    "empty": dict(capacity=0),
}


@pytest.mark.parametrize("config", sorted(CACHE_CONFIGS))
def test_result_cache_op_sequence_matches_reference(config):
    """Random puts (re-puts included), gets and partial exports: equal
    counters, equal answers and equal packed exports after every step."""
    kw = CACHE_CONFIGS[config]
    cj, ct = JCache(**kw), TCache(**kw)
    rng = np.random.default_rng(len(config))
    kinds = ("delta", "raw", "one", "none")
    for step in range(120):
        key = (int(rng.integers(0, 9)), int(rng.integers(0, 9)), 0)
        if rng.random() < 0.55:
            value = (int(rng.integers(0, 9)), _eids(rng, kinds[step % 4]))
            cj.put(key, value)
            ct.put(key, value)
        else:
            gj, gt = cj.get(key), ct.get(key)
            assert (gj is None) == (gt is None)
            if gj is not None:
                assert gj[0] == gt[0] and np.array_equal(gj[1], gt[1])
        _same_counters(cj, ct)
        assert (key in cj) == (key in ct)
    keys = [(a, b, 0) for a in range(9) for b in range(9)]
    assert cj.bytes_for(keys) == ct.bytes_for(keys) == ct.bytes
    _same_export(cj.export_packed(), ct.export_packed())

    # a move of the even keys into a second cache of the same policy
    pred = lambda k: (k[0] + k[1]) % 2 == 0             # noqa: E731
    mj, mt = cj.export_packed(pred, remove=True), ct.export_packed(pred, remove=True)
    _same_export(mj, mt)
    _same_counters(cj, ct)
    dj, dt = JCache(**kw), TCache(**kw)
    dj.import_packed(mj)
    dt.import_packed(mt)
    _same_counters(dj, dt)
    _same_export(dj.export_packed(), dt.export_packed())


def test_protected_tier_demotes_and_bytes_cap_evicts():
    """The hub tier demotes its LRU entry instead of dropping it, and the
    byte cap evicts from the unprotected tier first, as in the reference."""
    kw = dict(capacity=6, protect=lambda k: k[0] == 0, protected_frac=0.34,
              capacity_bytes=70)
    cj, ct = JCache(**kw), TCache(**kw)
    for c in (cj, ct):
        c.put((0, 1, 0), (1, np.arange(4, dtype=np.int32)))   # protected
        c.put((0, 2, 0), (1, np.arange(4, dtype=np.int32)))   # protected
        c.put((0, 3, 0), (1, np.arange(4, dtype=np.int32)))   # demotes (0, 1)
        c.put((5, 6, 0), (2, np.arange(20, dtype=np.int32)))  # byte pressure
    assert ct.protected_cap == cj.protected_cap == 2
    _same_counters(cj, ct)
    _same_export(cj.export_packed(), ct.export_packed())
    assert ct.evictions > 0 and ct.bytes <= 70


def test_cache_validation():
    for bad in (dict(capacity=-1), dict(capacity=1, capacity_bytes=-1)):
        with pytest.raises(ValueError):
            TCache(**bad)
    for c, s in [(5, 1), (5, 2), (8, 4), (7, 3)]:
        assert t_round(c, s) == j_round(c, s)
    with pytest.raises(ValueError):
        t_round(0, 2)


@pytest.fixture(scope="module")
def pair():
    """The reference index and the port's (segment relay) on one graph."""
    jidx = JIndex.build(j_gnp(V, 3.2, seed=17), n_landmarks=5, chunk=8)
    tidx = TIndex.build(t_gnp(V, 3.2, seed=17, device="cpu"), n_landmarks=5,
                        chunk=8, device="cpu")
    return jidx, tidx


def _batches(idx, seed):
    """Three batches over every lane; the later ones repeat earlier pairs so
    hits, second sightings and evictions all happen."""
    rng = np.random.default_rng(seed)
    lms = np.asarray(idx.scheme.landmarks)
    non = np.flatnonzero(~np.asarray(idx.scheme.is_landmark))
    us = np.concatenate([rng.integers(0, V, 24), lms[:3], [non[0]], [non[1]]])
    vs = np.concatenate([rng.integers(0, V, 24), lms[1:4], [lms[0]], [non[1]]])
    us, vs = us.astype(np.int32), vs.astype(np.int32)
    return [(us, vs), (vs[::2], us[::2]), (np.concatenate([us[:10], us[20:]]),
                                          np.concatenate([vs[:10], vs[20:]]))]


SERVICE_CONFIGS = {
    "lru_all": dict(cache_size=12),
    "hub_all": dict(cache_size=12, cache_policy="hub", hub_top_frac=0.1),
    "lru_reuse": dict(cache_size=12, cache_admission="reuse"),
    "hub_reuse": dict(cache_size=16, cache_policy="hub",
                      cache_admission="reuse", protected_frac=0.25),
    "bytes_only": dict(cache_size_bytes=200),
    "sync_bytes": dict(cache_size=30, cache_size_bytes=300, async_depth=1),
}


@pytest.mark.parametrize("config", sorted(SERVICE_CONFIGS))
def test_service_cache_policies_match_reference(pair, config):
    jidx, tidx = pair
    kw = SERVICE_CONFIGS[config]
    sj, st = JService(jidx, **kw), TService(tidx, **kw)
    for us, vs in _batches(jidx, seed=len(config)):
        rj, rt = sj.query_batch(us, vs), st.query_batch(us, vs)
        for a, b in zip(rj, rt):
            assert (a.u, a.v, a.dist, a.d_top) == (b.u, b.v, b.dist, b.d_top)
            assert np.array_equal(a.edge_ids, b.edge_ids)
            assert b.edge_ids.dtype == np.int32 and not b.edge_ids.flags.writeable
        dj, mj = sj.query_arrays(vs, us)
        dt, mt = st.query_arrays(vs, us)
        assert np.array_equal(dj, dt) and np.array_equal(mj, mt)
        assert sj.lane_served == st.lane_served
        _same_counters(sj.cache, st.cache)
        _same_export(sj.cache.export_packed(), st.cache.export_packed())
    assert st.cache.hits > 0
    assert st.stats == sj.stats


def test_service_validation_and_install_guards(pair):
    _, tidx = pair
    for bad in (dict(cache_size=4, cache_policy="lfu"),
                dict(cache_size=4, cache_admission="never")):
        with pytest.raises(ValueError, match="unknown"):
            TService(tidx, **bad)
    for multi in (dict(devices=1), dict(mesh=object())):
        with pytest.raises(ValueError, match="item 12"):
            TService(tidx, **multi)
    svc = tidx.make_service(cache_size=4)
    with pytest.raises(ValueError, match="not ahead"):
        svc.install_index(tidx)              # same epoch: a stale install
    nxt = tidx.apply_update(inserts=[(0, 37)])
    svc.install_index(nxt)
    assert svc.index is nxt and svc.stats["installs"] == 1
    with pytest.raises(ValueError, match="not ahead"):
        svc.install_index(nxt)

    class FakeSharded:
        is_sharded = True
        epoch = 99

    with pytest.raises(ValueError, match="sharded"):
        svc.install_index(FakeSharded())
