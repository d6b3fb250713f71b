"""Port vs reference: the streaming QoS scheduler (``serving.stream``).

The same submit / advance / poll / drain trace, under ``ManualClock``, goes
through ``repro.serving.StreamingService`` on the reference index and
``repro_torch.serving.StreamingService`` on the port's index (built from the
same seed; the port on its ``segment`` and ``hybrid`` relays).  Every
future's answer, epoch, class and submit time, the ``admission_log``, the
``stats`` and ``qos_stats`` (waits included), the latency histograms, the
lanes served and the cache counters must be equal, with the runtime
sanitizer off and on.  Then the port alone: a ``SystemClock`` deadline, the
replica handoff (``handoff_pending``/``adopt``) against the reference's, the
one-shot wrapper, the ``serve`` iterator and ``close``.  Zero tolerance.
"""
import threading
import time

import numpy as np
import pytest

from helpers.serving_oracle import assert_bit_identical

from repro.core import QbSIndex as JIndex
from repro.core import gnp_random_graph as j_gnp
from repro.serving import AdmissionPolicy as JPolicy
from repro.serving import ManualClock as JClock
from repro.serving import QoSClass as JQoS
from repro.serving import StreamingService as JStream
from repro_torch.core import QbSIndex as TIndex
from repro_torch.core import gnp_random_graph as t_gnp
from repro_torch.serving import AdmissionPolicy as TPolicy
from repro_torch.serving import ManualClock as TClock
from repro_torch.serving import QoSClass as TQoS
from repro_torch.serving import ServingService as TService
from repro_torch.serving import StreamingService as TStream
from repro_torch.serving import SystemClock
from repro_torch.serving.debug import ConcurrencyViolation

V = 45
JAX = (JStream, JClock, JQoS, JPolicy)
TORCH = (TStream, TClock, TQoS, TPolicy)
QOS = (("interactive", 0.002, 3.0), ("batch", 0.05, 1.0))


@pytest.fixture(scope="module")
def jidx():
    return JIndex.build(j_gnp(V, 3.2, seed=17), n_landmarks=5, chunk=8)


@pytest.fixture(scope="module")
def tidx():
    g = t_gnp(V, 3.2, seed=17, device="cpu")
    return {b: TIndex.build(g, n_landmarks=5, chunk=8, backend=b,
                            engine_opts={"n_hubs": 16} if b == "hybrid" else None,
                            device="cpu")
            for b in ("segment", "hybrid")}


def _trace(idx, seed):
    """Bursts across both classes with landmark, one-sided, trivial and
    repeated pairs, clock steps between them, idle polls and drains."""
    rng = np.random.default_rng(seed)
    lms = np.asarray(idx.scheme.landmarks)
    non = np.flatnonzero(~np.asarray(idx.scheme.is_landmark))
    ops = []
    seen = []
    for burst in range(10):
        n = int(rng.integers(3, 9))
        us = rng.integers(0, V, n).astype(np.int32)
        vs = rng.integers(0, V, n).astype(np.int32)
        if burst == 2:
            us[:3] = [lms[0], lms[1], non[0]]
            vs[:3] = [lms[2], non[3], non[0]]
        if seen and burst % 3 == 0:           # re-submit earlier pairs
            pu, pv = seen[int(rng.integers(len(seen)))]
            us[-2:], vs[-2:] = pv[:2], pu[:2]
        seen.append((us, vs))
        ops.append(("submit", us, vs, ("interactive", "batch", None)[burst % 3]))
        ops.append(("advance", float(rng.choice([0.0005, 0.001, 0.003, 0.02]))))
        if burst == 6:
            ops.append(("poll",))
        if burst == 7:
            ops.append(("drain",))
    ops.append(("advance", 0.1))
    ops.append(("drain",))
    return ops


def _run(api, idx, ops, *, qos=True, **kw):
    stream_cls, clock_cls, qos_cls, _ = api
    clock = clock_cls()
    classes = tuple(qos_cls(n, max_wait=w, weight=x) for n, w, x in QOS) \
        if qos else None
    st = stream_cls(idx, clock=clock, qos=classes, **kw)
    futs = []
    for op in ops:
        if op[0] == "submit":
            q = op[3] if qos else None
            futs += st.submit_batch(op[1], op[2], qos=q)
        elif op[0] == "advance":
            clock.advance(op[1])
        elif op[0] == "poll":
            st.poll()
        else:
            st.drain()
    return st, futs


def _same_stream(sj, st, fj, ft):
    assert len(fj) == len(ft)
    for a, b in zip(fj, ft):
        assert a.done() and b.done()
        assert (a.epoch, a.qos, a.t_submit) == (b.epoch, b.qos, b.t_submit)
        ra, rb = a.result(), b.result()
        assert (ra.u, ra.v, ra.dist, ra.d_top) == (rb.u, rb.v, rb.dist, rb.d_top)
        assert np.array_equal(ra.edge_ids, rb.edge_ids)
        assert rb.edge_ids.dtype == np.int32
    assert dict(sj.stats) == dict(st.stats)
    assert list(sj.admission_log) == list(st.admission_log)
    for name in sj.qos_stats:
        a, b = dict(sj.qos_stats[name]), dict(st.qos_stats[name])
        assert list(a.pop("waits")) == list(b.pop("waits"))
        assert a == b
        assert sj.lat_hist[name].snapshot() == st.lat_hist[name].snapshot()
    assert sj.service.lane_served == st.service.lane_served
    assert (sj.chunk, sj.n_pending, sj.n_inflight) == \
        (st.chunk, st.n_pending, st.n_inflight)
    cj, ct = sj.service.cache, st.service.cache
    assert (cj is None) == (ct is None)
    if cj is not None:
        assert (cj.hits, cj.misses, cj.evictions, cj.bytes, len(cj)) == \
            (ct.hits, ct.misses, ct.evictions, ct.bytes, len(ct))


CONFIGS = {
    "adaptive": dict(policy="adaptive"),
    "fixed_sync": dict(policy="fixed", async_depth=1),
    "hub_reuse_cache": dict(policy="adaptive", cache_size=24,
                            cache_policy="hub", cache_admission="reuse"),
    "lru_cache_deep": dict(policy="fixed", cache_size=16, async_depth=3),
}


def _policy(api, name):
    pol = api[3]
    if name == "adaptive":
        return pol(adaptive=True, min_chunk=2, max_chunk=32)
    return pol(adaptive=False, chunk=8)


@pytest.mark.parametrize("sanitize", [False, True], ids=["plain", "sanitized"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("backend", ["segment", "hybrid"])
def test_stream_trace_matches_reference(jidx, tidx, backend, config, sanitize):
    kw = dict(CONFIGS[config])
    pol = kw.pop("policy")
    ops = _trace(jidx, seed=len(config))
    sj, fj = _run(JAX, jidx, ops, policy=_policy(JAX, pol), sanitize=sanitize, **kw)
    st, ft = _run(TORCH, tidx[backend], ops, policy=_policy(TORCH, pol),
                  sanitize=sanitize, **kw)
    _same_stream(sj, st, fj, ft)
    assert st.stats["chunks"] > 0 and st.stats["deadline_flushes"] > 0
    sj.close()
    st.close()


def test_single_class_trace_matches_reference(jidx, tidx):
    """Untagged traffic (the default class, no deadlines) drains only on the
    size trigger and ``drain``."""
    ops = _trace(jidx, seed=3)
    sj, fj = _run(JAX, jidx, ops, qos=False)
    st, ft = _run(TORCH, tidx["segment"], ops, qos=False)
    _same_stream(sj, st, fj, ft)


def test_sanitizer_catches_off_lock_mutation(tidx):
    st = TStream(tidx["segment"], clock=TClock(), sanitize=True)
    with pytest.raises(ConcurrencyViolation):
        st.stats["submitted"] = 5
    with pytest.raises(ConcurrencyViolation):
        st._chunk = 2
    st.close()


def test_system_clock_lone_query_resolves_by_its_deadline(tidx):
    """A lone query with no further traffic is admitted by the class's
    deadline timer (on the clock's thread) and resolves without a drain."""
    idx = tidx["segment"]
    non = np.flatnonzero(~idx._is_landmark_np)
    want = idx.query_batch([non[1]], [non[2]])[0]
    st = TStream(idx, qos=(TQoS("interactive", max_wait=0.05),),
                 policy=TPolicy(adaptive=False, chunk=64))
    assert isinstance(st.clock, SystemClock)
    t0 = time.monotonic()
    fut = st.submit(int(non[1]), int(non[2]), qos="interactive")
    assert not fut.done()
    while not fut.done() and time.monotonic() - t0 < 20.0:
        time.sleep(0.005)
    assert fut.done(), "deadline timer did not admit the lone query"
    assert threading.current_thread() is threading.main_thread()
    got = fut.result()
    assert got.dist == want.dist and np.array_equal(got.edge_ids, want.edge_ids)
    assert st.stats["deadline_flushes"] == 1
    assert st.lat_hist["interactive"].total == 1
    st.close()
    assert st._timer is None


def test_handoff_and_adopt_match_reference(jidx, tidx):
    """Pending pairs exported from one stream and adopted by another (the
    replica drain path): the futures re-target, keep submit times and
    deadlines, and resolve on the adopter, as in the reference."""
    out = []
    for api, idx in ((JAX, jidx), (TORCH, tidx["segment"])):
        stream_cls, clock_cls, qos_cls, pol = api
        classes = tuple(qos_cls(n, max_wait=w, weight=x) for n, w, x in QOS)
        ca, cb = clock_cls(), clock_cls()
        a = stream_cls(idx, clock=ca, qos=classes, cache_size=32,
                       policy=pol(adaptive=False, chunk=64))
        b = stream_cls(idx, clock=cb, qos=classes, cache_size=32,
                       policy=pol(adaptive=False, chunk=64))
        rng = np.random.default_rng(5)
        us = rng.integers(0, V, 12).astype(np.int32)
        vs = rng.integers(0, V, 12).astype(np.int32)
        warm = b.submit_batch(us[:3], vs[:3], qos="batch")   # b's cache
        b.drain()
        futs = a.submit_batch(us, vs, qos="batch")
        futs += a.submit_batch(vs[4:8], us[4:8], qos="interactive")
        handed = a.handoff_pending()
        for key, fs, q, t_enq, deadline in handed:
            b.adopt(key, fs, qos=q, t_enq=t_enq, deadline=deadline)
        for c in (ca, cb):
            c.advance(0.01)
        a.drain()
        b.drain()
        out.append((a, b, warm + futs, handed))
    (ja, jb, jf, jh), (ta, tb, tf, th) = out
    assert [h[0] for h in jh] == [h[0] for h in th]
    assert [(h[2], h[3], h[4]) for h in jh] == [(h[2], h[3], h[4]) for h in th]
    _same_stream(ja, ta, [], [])
    _same_stream(jb, tb, jf, tf)
    assert tb.stats["cache_hits"] > 0 and ta.stats["handed_off"] > 0
    for f in tf:
        assert f._stream is tb or f.done()


def test_one_shot_wrapper_serve_iterator_and_close(tidx):
    idx = tidx["hybrid"]
    rng = np.random.default_rng(7)
    us = rng.integers(0, V, 20).astype(np.int32)
    vs = rng.integers(0, V, 20).astype(np.int32)
    want = TService(idx).query_batch(us, vs)
    with idx.make_stream(cache_size=64, clock=TClock()) as st:
        for _ in range(2):                   # the second pass hits the cache
            got = st.query_batch(us, vs)
            for a, b in zip(want, got):
                assert (a.u, a.v, a.dist, a.d_top) == (b.u, b.v, b.dist, b.d_top)
                assert np.array_equal(a.edge_ids, b.edge_ids)
        assert st.stats["cache_hits"] > 0
        res = list(st.serve(zip(vs.tolist(), us.tolist())))
    assert_bit_identical(idx.graph, res, vs, us)
    assert st.n_pending == 0 and st.n_inflight == 0
    st.close()                               # idempotent
