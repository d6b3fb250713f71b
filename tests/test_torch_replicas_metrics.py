"""Port vs reference: the replica tier (``serving.replicas``) and the metrics
layer (``serving.metrics``), and the serving CLI's ``--replicas`` and
``--metrics-port``.

Ring placement (``mix64``, ``key_point``, ``owner_of``) must be equal over
many keys; the same trace through a ``ReplicaRouter`` of each package, with a
replica drained and restored mid-trace (pending pairs handed off, packed
cache entries shipped both ways) and an epoch fanned out to every replica,
must give equal answers, equal per-replica stats and cache bytes, and the
same Prometheus text.  Zero tolerance.
"""
import re
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import QbSIndex as JIndex  # noqa: E402
from repro.core import gnp_random_graph as j_gnp  # noqa: E402
from repro.serving import AdmissionPolicy as JPolicy  # noqa: E402
from repro.serving import LatencyHistogram as JHist  # noqa: E402
from repro.serving import ManualClock as JClock  # noqa: E402
from repro.serving import MetricsRegistry as JRegistry  # noqa: E402
from repro.serving import QoSClass as JQoS  # noqa: E402
from repro.serving import ReplicaRouter as JRouter  # noqa: E402
from repro.serving import merged_latency as j_merged  # noqa: E402
from repro.serving.replicas import key_point as j_key_point  # noqa: E402
from repro.serving.replicas import mix64 as j_mix64  # noqa: E402
from repro_torch.core import QbSIndex as TIndex  # noqa: E402
from repro_torch.core import gnp_random_graph as t_gnp  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.serving import AdmissionPolicy as TPolicy  # noqa: E402
from repro_torch.serving import LatencyHistogram as THist  # noqa: E402
from repro_torch.serving import ManualClock as TClock  # noqa: E402
from repro_torch.serving import MetricsRegistry as TRegistry  # noqa: E402
from repro_torch.serving import QoSClass as TQoS  # noqa: E402
from repro_torch.serving import ReplicaRouter as TRouter  # noqa: E402
from repro_torch.serving import merged_latency as t_merged  # noqa: E402
from repro_torch.serving import serve_metrics  # noqa: E402
from repro_torch.serving.replicas import key_point as t_key_point  # noqa: E402
from repro_torch.serving.replicas import mix64 as t_mix64  # noqa: E402

V = 40
JAX = (JRouter, JClock, JQoS, JPolicy, JRegistry)
TORCH = (TRouter, TClock, TQoS, TPolicy, TRegistry)


@pytest.fixture(scope="module")
def jidx():
    return JIndex.build(j_gnp(V, 3.0, seed=23), n_landmarks=4, chunk=8)


@pytest.fixture(scope="module")
def tidx():
    return TIndex.build(t_gnp(V, 3.0, seed=23, device="cpu"), n_landmarks=4,
                        chunk=8, backend="hybrid", engine_opts={"n_hubs": 8},
                        device="cpu")


def test_mix64_and_key_point_match_reference():
    rng = np.random.default_rng(0)
    for x in rng.integers(0, 1 << 62, size=500).tolist() + [0, 1, (1 << 64) - 1]:
        assert t_mix64(x) == j_mix64(x)
    for a, b in rng.integers(0, 1 << 31, size=(500, 2)).tolist():
        assert t_key_point((a, b)) == j_key_point((a, b))


@pytest.mark.parametrize("n_replicas,vnodes", [(2, 64), (3, 16), (5, 7)])
def test_owner_of_matches_reference(jidx, tidx, n_replicas, vnodes):
    rj = JRouter(jidx, n_replicas=n_replicas, vnodes=vnodes,
                 clocks=[JClock() for _ in range(n_replicas)])
    rt = TRouter(tidx, n_replicas=n_replicas, vnodes=vnodes,
                 clocks=[TClock() for _ in range(n_replicas)])
    rng = np.random.default_rng(n_replicas)
    keys = rng.integers(0, 1 << 20, size=(2000, 2)).tolist()
    assert [rt.owner_of(u, v) for u, v in keys] == \
        [rj.owner_of(u, v) for u, v in keys]
    rj.drain_replica(0)
    rt.drain_replica(0)
    assert [rt.owner_of(u, v) for u, v in keys] == \
        [rj.owner_of(u, v) for u, v in keys]
    assert rt.live_replicas() == rj.live_replicas()
    rj.close()
    rt.close()


def _router_trace(api, idx, *, sanitize=False):
    """Bursts under two classes, a replica drained with work pending and
    restored later (cache shipped both ways), an epoch fanned out, and a
    final drain.  Returns the router, the registry, all futures and the
    updated index."""
    router_cls, clock_cls, qos_cls, pol, reg_cls = api
    clocks = [clock_cls() for _ in range(3)]
    qos = (qos_cls("interactive", max_wait=0.002, weight=4.0),
           qos_cls("bulk", max_wait=0.05, weight=1.0))
    router = router_cls(idx, n_replicas=3, clocks=clocks, qos=qos,
                        policy=pol(adaptive=False, chunk=64), cache_size=64,
                        cache_policy="hub", sanitize=sanitize)
    reg = reg_cls()
    for i, rep in enumerate(router.replicas):
        reg.register(f"replica{i}", rep)
    rng = np.random.default_rng(41)
    hot_u = rng.integers(0, V, 12).astype(np.int32)
    hot_v = rng.integers(0, V, 12).astype(np.int32)

    def advance(dt):
        for c in clocks:
            c.advance(dt)

    futs = router.submit_batch(hot_u, hot_v, qos="bulk")
    advance(0.06)
    router.drain()                            # warm every owner's cache
    futs += router.submit_batch(hot_v[:6], hot_u[:6], qos="interactive")
    futs += router.submit_batch(rng.integers(0, V, 8), rng.integers(0, V, 8),
                                qos="bulk")    # pending when the drain comes
    router.drain_replica(1)
    futs += router.submit_batch(hot_u, hot_v, qos="interactive")
    advance(0.003)
    router.restore_replica(1)
    futs += router.submit_batch(hot_v, hot_u, qos="bulk")
    advance(0.06)
    router.drain()
    src, dst = np.asarray(idx.graph.src), np.asarray(idx.graph.dst)
    real = src < dst                          # the first real edge, cut
    new = router.apply_update(deletes=[(int(src[real][0]), int(dst[real][0]))])
    futs += router.submit_batch(hot_u, hot_v, qos="bulk")
    advance(0.06)
    router.drain()
    return router, reg, futs, new


@pytest.mark.parametrize("sanitize", [False, True], ids=["plain", "sanitized"])
def test_router_trace_matches_reference(jidx, tidx, sanitize):
    rj, gj, fj, nj = _router_trace(JAX, jidx, sanitize=sanitize)
    rt, gt, ft, nt = _router_trace(TORCH, tidx, sanitize=sanitize)
    assert nt.epoch == nj.epoch == 1
    assert all(rep.index is nt for rep in rt.replicas)
    assert len(fj) == len(ft)
    for a, b in zip(fj, ft):
        assert a.epoch == b.epoch and a.qos == b.qos
        ra, rb = a.result(), b.result()
        assert (ra.u, ra.v, ra.dist, ra.d_top) == (rb.u, rb.v, rb.dist, rb.d_top)
        assert np.array_equal(ra.edge_ids, rb.edge_ids)
    assert dict(rj.stats) == dict(rt.stats)
    assert rt.stats["cache_shipped"] > 0 and rt.stats["handoffs"] > 0
    for a, b in zip(rj.replicas, rt.replicas):
        assert dict(a.stats) == dict(b.stats)
        assert list(a.admission_log) == list(b.admission_log)
        ca, cb = a.service.cache, b.service.cache
        assert (ca.hits, ca.misses, ca.evictions, ca.bytes, len(ca)) == \
            (cb.hits, cb.misses, cb.evictions, cb.bytes, len(cb))
        assert [k for k, _ in ca.export_packed()] == \
            [k for k, _ in cb.export_packed()]
    assert gj.snapshot() == gt.snapshot()
    assert gj.render_text() == gt.render_text()
    # one latency observation per resolved future, over the tier
    text = gt.render_text()
    counts = [int(m) for m in re.findall(r"qbs_latency_us_count\{[^}]*\} (\d+)",
                                         text)]
    assert sum(counts) == len(ft)
    rj.close()
    rt.close()


def test_histograms_and_merge_match_reference():
    rng = np.random.default_rng(3)
    hj, ht = JHist(), THist()
    for us in np.concatenate([rng.exponential(300.0, 400), [0.0, 0.5, 2.0**40]]):
        hj.observe(us)
        ht.observe(us)
    assert hj.snapshot() == ht.snapshot()
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert hj.quantile(q) == ht.quantile(q)
    assert j_merged([hj, hj]).snapshot() == t_merged([ht, ht]).snapshot()


def test_scrape_endpoint_serves_the_registry_text(tidx):
    router, reg, futs, _ = _router_trace(TORCH, tidx)
    server = serve_metrics(reg, port=0)
    port = server.server_address[1]
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as resp:
            assert resp.status == 200
            body = resp.read().decode()
        assert body == reg.render_text()
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope", timeout=10)
        assert err.value.code == 404
    finally:
        server.shutdown()
        server.server_close()
        router.close()


def _deterministic_lines(text):
    """The CLI's lines that do not carry a wall time."""
    keep = ("[serve] graph", "[serve] replica tier", "[serve] dist:",
            "[serve] router:")
    return [ln for ln in text.splitlines() if ln.startswith(keep)]


def test_cli_replicas_and_metrics_port_on_cpu(capsys, monkeypatch):
    """``--replicas 2 --metrics-port 0`` with ``--device cpu`` prints the
    reference CLI's lines (timings aside) for the same arguments."""
    import sys

    from repro.launch import serve as j_serve

    args = ["--graph", "ba", "--n", "300", "--landmarks", "6", "--queries",
            "24", "--replicas", "2", "--metrics-port", "0"]
    t_serve.main(args + ["--backend", "hybrid", "--device", "cpu"])
    port_out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["serve"] + args)
    j_serve.main()
    ref_out = capsys.readouterr().out
    assert re.search(r"\[serve\] metrics: http://127\.0\.0\.1:\d+/metrics", port_out)
    lines = _deterministic_lines(port_out)
    assert len(lines) == 4
    assert lines == _deterministic_lines(ref_out)
    # the replica tier over the vertex-sharded index: the same lines
    t_serve.main(args + ["--shards", "2", "--device", "cpu"])
    assert _deterministic_lines(capsys.readouterr().out) == lines
