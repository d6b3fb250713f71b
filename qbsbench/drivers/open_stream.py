"""Open-loop arrivals through ``StreamingService`` on the real clock.

The schedule (``trafficgen.stream_schedule``) fixes every arrival's due
time, class and pair from the seed; the client submits each one when it is
due, whatever the service is doing, and a request's latency runs from its
due time to the moment its future resolved (the harness stamps each
resolution).  So a stall of the client counts against every request it
delays, and how late the client ran is reported beside the p50.  After
the last arrival the client drains the stream; every request of the
window is waited for and counted.

The service is the traffic file's: QoS classes, the result cache and the
adaptive admission policy.  Warm-up, counted as set-up: one general chunk
at each width of the admission ladder and one chunk of each landmark lane,
through a service without a cache, from a seed stream the window never
uses.  A traced run profiles a slice of the window starting at a third of
it.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.serving import AdmissionPolicy, QoSClass, QueryFuture

from qbsbench.harness import Window
from qbsbench.graphgen import rng_for
from qbsbench.trafficgen import WARMUP_STREAM, HostGraph, stream_schedule

PROFILED_S = 2.0
NEVER = 1e9      # the latency of a request that never resolved, in s


def make_stream(index, traffic: dict):
    qos = tuple(QoSClass(q["name"], max_wait=q["max_wait_ms"] * 1e-3,
                         weight=float(q["weight"])) for q in traffic["qos"])
    a = traffic["admission"]
    policy = AdmissionPolicy(adaptive=bool(a["adaptive"]),
                             min_chunk=int(a["min_chunk"]),
                             max_chunk=int(a["max_chunk"]))
    c = traffic["cache"]
    return index.make_stream(policy=policy, qos=qos, cache_size=int(c["size"]),
                             cache_policy=c["policy"],
                             async_depth=int(traffic["async_depth"]))


def warm_up(system, traffic: dict, seed: int, rec) -> None:
    index = system.index
    a = traffic["admission"]
    rng = rng_for(seed, WARMUP_STREAM)
    lm = system.landmarks
    x = int(np.flatnonzero(~system.is_landmark)[0])
    w = int(a["min_chunk"])
    while w <= int(a["max_chunk"]):
        svc = index.make_service(chunk=w)
        us = rng.integers(0, system.n_vertices, size=w).astype(np.int32)
        vs = rng.integers(0, system.n_vertices, size=w).astype(np.int32)
        if w == int(a["min_chunk"]):
            us = np.concatenate([us, [lm[0], lm[1]]]).astype(np.int32)
            vs = np.concatenate([vs, [lm[1], x]]).astype(np.int32)
        svc.query_batch(us, vs)
        w *= 2
    rec.synchronize()


def quantile_ms(x: np.ndarray, q: float) -> float:
    return float(np.percentile(x, q)) * 1e3 if x.size else float("nan")


def drive(stream, sched: dict, classes: list, rec=None, profile_at=None):
    """Submit every arrival of ``sched`` when due; returns ``(futures, due
    times, submit times, resolve stamps)`` (``perf_counter`` seconds)."""
    stamps: dict = {}
    t = sched["t"]
    n = t.size
    futs = [None] * n
    subm = np.empty((n,))
    orig = QueryFuture._resolve

    def _resolve(fut, *a):
        orig(fut, *a)
        if fut.done():
            stamps[fut] = time.perf_counter()

    QueryFuture._resolve = _resolve
    try:
        t0 = time.perf_counter() + 1e-3
        due = t0 + t
        prof = None
        u, v, cls = sched["u"].tolist(), sched["v"].tolist(), sched["cls"].tolist()
        for i in range(n):
            wait = due[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            if profile_at is not None:
                if prof is None and t[i] >= profile_at:
                    prof = rec.profiled()
                    prof.__enter__()
                elif prof is not None and t[i] >= profile_at + PROFILED_S:
                    prof.__exit__(None, None, None)
                    prof, profile_at = None, None
            subm[i] = time.perf_counter()
            futs[i] = stream.submit(u[i], v[i], qos=classes[cls[i]])
        if prof is not None:
            prof.__exit__(None, None, None)
        stream.drain()
        stream.close()
    finally:
        QueryFuture._resolve = orig
    done = np.array([stamps.get(f, np.nan) for f in futs])
    return futs, due, subm, done


def run(system, traffic: dict, seed: int, seconds: float, rec) -> Window:
    index = system.index
    hg = HostGraph(system.edges, system.n_vertices)
    sched = stream_schedule(traffic, hg, seed, seconds)
    warm_up(system, traffic, seed, rec)
    stream = make_stream(index, traffic)
    classes = [q["name"] for q in traffic["qos"]]

    rec.reset_counters()
    launches0 = system.launches()
    rec.setup_done()
    futs, due, subm, done = drive(stream, sched, classes, rec,
                                  profile_at=seconds / 3 if rec.trace else None)
    rec.raw["stream_stats"] = dict(stream.stats)
    rec.raw["launches"] = {k: v - launches0[k] for k, v in system.launches().items()}
    rec.raw["lane_served"] = list(stream.service.lane_served)

    lat = done - due
    ok = np.isfinite(lat)
    answers = []
    for f, good in zip(futs, ok):
        if good:
            r = f.result()
            answers.append((r.u, r.v, r.dist, r.edge_ids))
        else:
            answers.append((f.u, f.v, None, None))
    # a request that never resolved counts as missing every limit
    lat_all = np.where(ok, lat, NEVER)
    late = subm - due
    p95 = quantile_ms(lat_all, 95)
    p95 = p95 if p95 < NEVER else None
    notes = [f"window: {len(futs)} arrivals over {seconds} s "
             f"({len(futs) / seconds:.1f} per s offered); client late by "
             f"p50 {quantile_ms(late, 50):.3f} ms, p99 {quantile_ms(late, 99):.3f} ms, "
             f"max {late.max() * 1e3 if late.size else 0:.3f} ms; latency p50 "
             f"{quantile_ms(lat_all, 50):.3f} ms, p95 {quantile_ms(lat_all, 95):.3f} ms, p99 "
             f"{quantile_ms(lat_all, 99):.3f} ms; unresolved {int((~ok).sum())}; "
             f"stats {dict(stream.stats)}"]
    return Window(attempted=len(futs), answers=answers,
                  metrics={"p95_ms": p95}, notes=notes)
