"""The serving fuzz drivers of ``tests/test_property_serving.py``, carried
over with the package as a parameter (``"ref"``, the JAX package, or
``"port"``, ``repro_torch`` on the CPU), so one randomized trace runs on
either.  Each driver asserts the reference harness's invariants (numpy
oracle bit-identity, every future resolved, duplicates identical, deadline
bounds in simulated time, accounting) and returns what the two packages
must agree on: every future's answer, class and epoch, and the stats."""
import functools
import os
import types

import numpy as np

from helpers.serving_oracle import EpochOracle, OracleCache

import repro.core as j_core
import repro.core.graph as j_graph
import repro.serving as j_serving
import repro_torch.core as t_core
import repro_torch.core.graph as t_graph
import repro_torch.serving as t_serving

V_BUCKET = 32
E_BUCKET = 256          # directed slots
N_GRAPH_SEEDS = 6       # distinct (graph, index) builds, memoized
SCALE = max(1, int(os.environ.get("QBS_PROPERTY_EXAMPLES_SCALE", "1")))
UPDATE_SEEDS = range(18 * SCALE)   # the reference's update sweep
DTS = (0.0, 0.005, 0.02, 0.1, 0.6)

PKGS = {
    "ref": types.SimpleNamespace(core=j_core, serving=j_serving, edge_set=j_graph.edge_set,
                                 build_kw={}),
    "port": types.SimpleNamespace(core=t_core, serving=t_serving, edge_set=t_graph.edge_set,
                                  build_kw={"device": "cpu"}),
}


def catalog(pkg: str):
    """The reference harness's policy-surface catalog, in one package's
    classes: (QOS_CONFIGS, POLICIES, CACHES)."""
    S = PKGS[pkg].serving
    qos = (
        None,
        (S.QoSClass("interactive", max_wait=0.02, weight=4.0),
         S.QoSClass("batch", max_wait=None, weight=1.0)),
        (S.QoSClass("now", max_wait=0.0, weight=1.0),
         S.QoSClass("soon", max_wait=0.05, weight=2.0),
         S.QoSClass("whenever", max_wait=0.5, weight=0.5)),
        (S.QoSClass("a", max_wait=0.01, weight=1.0),
         S.QoSClass("b", max_wait=0.01, weight=1.0)),
    )
    policies = (
        S.AdmissionPolicy(adaptive=True, min_chunk=2, max_chunk=8),
        S.AdmissionPolicy(adaptive=False, chunk=4, min_chunk=2, max_chunk=8),
        S.AdmissionPolicy(adaptive=True, chunk=2, min_chunk=2, max_chunk=4),
    )
    caches = (
        {},
        {"cache_size": 8},
        {"cache_size": 8, "cache_policy": "hub"},
        {"cache_size": 8, "cache_admission": "reuse"},
        {"cache_size": 8, "cache_policy": "hub", "cache_admission": "reuse"},
    )
    return qos, policies, caches


@functools.lru_cache(maxsize=None)
def built(pkg: str, graph_seed: int, backend: str = "segment"):
    """(graph, n, index) for one fuzz graph seed in one package, memoized:
    the same edges, landmarks and chunk in both."""
    P = PKGS[pkg]
    rng = np.random.default_rng(1000 + graph_seed)
    n = int(rng.integers(8, V_BUCKET))
    m = int(rng.integers(n, 2 * n))
    edges = rng.integers(0, n, size=(m, 2))
    g = P.core.from_edges(edges, n, pad_vertices_to=V_BUCKET, pad_edges_to=E_BUCKET,
                          **P.build_kw)
    deg = np.asarray(g.degrees())[:n]
    nl = int(rng.integers(1, 5))
    landmarks = np.sort(np.argsort(-deg)[:nl]).astype(np.int32)
    return g, n, P.core.QbSIndex.build(g, landmarks=landmarks, chunk=4,
                                       backend=backend, **P.build_kw)


def answers(futs) -> list:
    return [(f.u, f.v, f.qos, f.epoch, f.result().dist,
             tuple(np.asarray(f.result().edge_ids).tolist())) for f in futs]


def run_trace(pkg: str, seed: int, n_ops: int = 24):
    """One stream fuzz example (the reference harness's ``_run_trace``) on
    ``pkg``; asserts every invariant and returns what the two packages
    must agree on."""
    S = PKGS[pkg].serving
    qos_configs, policies, caches = catalog(pkg)
    rng = np.random.default_rng(seed)
    g, n, idx = built(pkg, int(rng.integers(N_GRAPH_SEEDS)))
    qos = qos_configs[int(rng.integers(len(qos_configs)))]
    clk = S.ManualClock()
    st = S.StreamingService(
        idx, policy=policies[int(rng.integers(len(policies)))],
        qos=qos, clock=clk,
        async_depth=int(rng.integers(1, 3)),
        **caches[int(rng.integers(len(caches)))])
    names = [c.name for c in st.qos_classes]
    max_wait = {c.name: c.max_wait for c in st.qos_classes}

    futs: list = []
    recent: list[tuple[int, int]] = []

    def draw_pair():
        if recent and rng.random() < 0.3:       # duplicate (maybe swapped)
            u, v = recent[int(rng.integers(len(recent)))]
            return (v, u) if rng.random() < 0.5 else (u, v)
        u, v = int(rng.integers(n)), int(rng.integers(n))
        recent.append((u, v))
        return u, v

    for _ in range(n_ops):
        r = rng.random()
        if r < 0.45:
            u, v = draw_pair()
            futs.append(st.submit(u, v, qos=names[int(rng.integers(len(names)))]))
        elif r < 0.60:
            pairs = [draw_pair() for _ in range(int(rng.integers(2, 7)))]
            futs.extend(st.submit_batch(
                [p[0] for p in pairs], [p[1] for p in pairs],
                qos=names[int(rng.integers(len(names)))]))
        elif r < 0.80:
            clk.advance(DTS[int(rng.integers(len(DTS)))])
        elif r < 0.88:
            st.drain()
        elif r < 0.95:
            st.poll()
        elif futs:
            f = futs[int(rng.integers(len(futs)))]
            f.result()                          # implicit drain; idempotent
            assert f.done()
    st.drain()

    assert st.n_pending == 0 and st.n_inflight == 0
    assert not st._waiting and not st._pending and not st._deadline
    assert not st._flight
    assert all(f.done() for f in futs)

    oracle = OracleCache(g)
    by_key: dict[tuple[int, int], list] = {}
    for f in futs:
        res = f.result()
        oracle.assert_result(res)
        by_key.setdefault((min(f.u, f.v), max(f.u, f.v)), []).append(res)
    for group in by_key.values():
        for r in group[1:]:
            assert r.dist == group[0].dist
            assert np.array_equal(r.edge_ids, group[0].edge_ids)

    for name in names:
        mw = max_wait[name]
        waits = st.qos_stats[name]["waits"]
        assert all(w >= 0 for w in waits)
        if mw is not None:
            assert all(w <= mw + 1e-9 for w in waits), (name, mw, max(waits))

    s = st.stats
    fresh = (s["submitted"] - s["trivial"] - s["cache_hits"] - s["joined"]
             - s["handed_off"])
    assert s["admitted_pairs"] == fresh
    assert sum(st.qos_stats[nm]["admitted"] for nm in names) == fresh
    assert sum(st.service.lane_served) == \
        s["trivial"] + s["cache_hits"] + s["admitted_pairs"]
    assert len(futs) == s["submitted"]

    reg = S.MetricsRegistry()
    reg.register("svc", st)
    snap = reg.snapshot()["svc"]
    assert snap["stats"] == dict(s)
    for name in names:
        assert st.lat_hist[name].total == st.qos_stats[name]["submitted"]
        assert snap["latency_us"][name] == st.lat_hist[name].snapshot()
    assert sum(h.total for h in st.lat_hist.values()) == s["submitted"]
    return (answers(futs), dict(s), {nm: dict(st.qos_stats[nm]) for nm in names},
            list(st.service.lane_served))


def run_router_trace(pkg: str, seed: int, n_ops: int = 24):
    """One replica-tier fuzz example (the reference harness's
    ``_run_router_trace``) on ``pkg``: 3 replicas with lockstep
    ``ManualClock``s and random drains/restores."""
    S = PKGS[pkg].serving
    qos_configs, policies, caches = catalog(pkg)
    rng = np.random.default_rng(10_000 + seed)
    g, n, idx = built(pkg, int(rng.integers(N_GRAPH_SEEDS)))
    qos = qos_configs[int(rng.integers(len(qos_configs)))]
    n_rep = 3
    clks = [S.ManualClock() for _ in range(n_rep)]
    router = S.ReplicaRouter(
        idx, n_replicas=n_rep, clocks=clks,
        policy=policies[int(rng.integers(len(policies)))],
        qos=qos, async_depth=int(rng.integers(1, 3)),
        **caches[int(rng.integers(len(caches)))])
    names = [c.name for c in router.replicas[0].qos_classes]
    max_wait = {c.name: c.max_wait for c in router.replicas[0].qos_classes}

    futs: list = []
    recent: list[tuple[int, int]] = []

    def draw_pair():
        if recent and rng.random() < 0.3:
            u, v = recent[int(rng.integers(len(recent)))]
            return (v, u) if rng.random() < 0.5 else (u, v)
        u, v = int(rng.integers(n)), int(rng.integers(n))
        recent.append((u, v))
        return u, v

    for _ in range(n_ops):
        r = rng.random()
        if r < 0.40:
            u, v = draw_pair()
            futs.append(router.submit(
                u, v, qos=names[int(rng.integers(len(names)))]))
        elif r < 0.55:
            pairs = [draw_pair() for _ in range(int(rng.integers(2, 7)))]
            futs.extend(router.submit_batch(
                [p[0] for p in pairs], [p[1] for p in pairs],
                qos=names[int(rng.integers(len(names)))]))
        elif r < 0.72:
            dt = DTS[int(rng.integers(len(DTS)))]
            for c in clks:                          # lockstep time base
                c.advance(dt)
        elif r < 0.80:
            router.drain()
        elif r < 0.86:
            router.poll()
        elif r < 0.96:                              # rolling restart step
            live = router.live_replicas()
            down = [i for i in range(n_rep) if i not in live]
            if down and rng.random() < 0.5:
                router.restore_replica(down[int(rng.integers(len(down)))])
            elif len(live) > 1:
                router.drain_replica(live[int(rng.integers(len(live)))])
        elif futs:
            f = futs[int(rng.integers(len(futs)))]
            f.result()
            assert f.done()
    router.drain()

    for rep in router.replicas:
        assert rep.n_pending == 0 and rep.n_inflight == 0
        assert not rep._waiting and not rep._pending and not rep._flight
    assert all(f.done() for f in futs)

    oracle = OracleCache(g)
    by_key: dict[tuple[int, int], list] = {}
    for f in futs:
        res = f.result()
        oracle.assert_result(res)
        by_key.setdefault((min(f.u, f.v), max(f.u, f.v)), []).append(res)
    for group in by_key.values():
        for r in group[1:]:
            assert r.dist == group[0].dist
            assert np.array_equal(r.edge_ids, group[0].edge_ids)

    for rep in router.replicas:
        s = rep.stats
        fresh = (s["submitted"] - s["trivial"] - s["cache_hits"]
                 - s["joined"] - s["handed_off"])
        assert s["admitted_pairs"] == fresh, dict(s)
        for name in names:
            mw = max_wait[name]
            waits = rep.qos_stats[name]["waits"]
            assert all(w >= 0 for w in waits)
            if mw is not None:
                assert all(w <= mw + 1e-9 for w in waits), (name, mw, max(waits))
    assert router.stats["routed"] == len(futs)
    assert sum(h.total for rep in router.replicas
               for h in rep.lat_hist.values()) == len(futs)
    out = (answers(futs), dict(router.stats),
           [dict(rep.stats) for rep in router.replicas])
    router.close()
    return out


def run_update_trace(pkg: str, seed: int, n_ops: int = 22):
    """One dynamic-graph fuzz example (the reference harness's
    ``_run_update_trace``) on ``pkg``: the stream trace space plus random
    mid-trace ``submit_update`` batches on a drawn relay backend, each
    future checked against the per-epoch numpy oracle at the epoch it
    resolved under."""
    P = PKGS[pkg]
    S = P.serving
    qos_configs, policies, caches = catalog(pkg)
    rng = np.random.default_rng(50_000 + seed)
    backend = ("segment", "csr", "hybrid")[int(rng.integers(3))]
    g, n, idx = built(pkg, int(rng.integers(N_GRAPH_SEEDS)), backend)
    clk = S.ManualClock()
    st = S.StreamingService(
        idx, policy=policies[int(rng.integers(len(policies)))],
        qos=qos_configs[int(rng.integers(len(qos_configs)))], clock=clk,
        async_depth=int(rng.integers(1, 3)),
        **caches[int(rng.integers(len(caches)))])
    names = [c.name for c in st.qos_classes]
    oracle = EpochOracle(g)

    futs: list = []
    recent: list[tuple[int, int]] = []

    def draw_pair():
        if recent and rng.random() < 0.35:
            u, v = recent[int(rng.integers(len(recent)))]
            return (v, u) if rng.random() < 0.5 else (u, v)
        u, v = int(rng.integers(n)), int(rng.integers(n))
        recent.append((u, v))
        return u, v

    def draw_update():
        ins, dels = [], []
        present = [tuple(int(x) for x in e) for e in P.edge_set(st.index.graph)]
        for _ in range(int(rng.integers(1, 3))):
            if rng.random() < 0.5 and present:
                dels.append(present[int(rng.integers(len(present)))])
            else:
                a, b = int(rng.integers(n)), int(rng.integers(n))
                if a != b:
                    ins.append((a, b))       # may be present: phantom no-op
        return ins, dels

    for _ in range(n_ops):
        r = rng.random()
        if r < 0.35:
            u, v = draw_pair()
            futs.append(st.submit(u, v, qos=names[int(rng.integers(len(names)))]))
        elif r < 0.50:
            pairs = [draw_pair() for _ in range(int(rng.integers(2, 6)))]
            futs.extend(st.submit_batch(
                [p[0] for p in pairs], [p[1] for p in pairs],
                qos=names[int(rng.integers(len(names)))]))
        elif r < 0.65:                       # the update op
            ins, dels = draw_update()
            churn = (0.0, 0.6, 1.1)[int(rng.integers(3))]
            new = st.submit_update(inserts=ins, deletes=dels,
                                   churn_threshold=churn)
            oracle.advance(new.graph, inserts=ins, deletes=dels)
            assert st.index.epoch == oracle.epoch
        elif r < 0.80:
            clk.advance(DTS[int(rng.integers(len(DTS)))])
        elif r < 0.88:
            st.drain()
        elif r < 0.95:
            st.poll()
        elif futs:
            futs[int(rng.integers(len(futs)))].result()
    st.drain()

    assert st.n_pending == 0 and st.n_inflight == 0
    assert not st._waiting and not st._pending and not st._flight
    assert st.stats["updates"] == oracle.epoch

    by_key: dict[tuple[int, int, int], list] = {}
    for f in futs:
        oracle.assert_future(f)              # per-epoch bit-identity
        by_key.setdefault((min(f.u, f.v), max(f.u, f.v), f.epoch),
                          []).append(f.result())
    for group in by_key.values():
        for r in group[1:]:
            assert r.dist == group[0].dist
            assert np.array_equal(r.edge_ids, group[0].edge_ids)

    s = st.stats
    assert s["admitted_pairs"] == (s["submitted"] - s["trivial"]
                                   - s["cache_hits"] - s["joined"]
                                   - s["handed_off"])
    out = (answers(futs), dict(s), [int(x) for x in st.index.graph.src.tolist()])
    st.close()
    return out
