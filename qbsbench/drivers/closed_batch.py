"""Closed-loop batches: one client sends a batch of pairs through
``ServingService.query_batch`` and sends the next when it has the
answers.  The window is made of whole batches and lasts at least the
run's seconds; ``qps`` is every query answered in it over its whole wall
time.

Warm-up, counted as set-up: one batch that fills one chunk of each lane
(general pairs of the mix's own kind, a landmark pair, a one-sided pair
and a ``u == v`` pair), from a seed stream the window never uses.  A
traced run profiles its second batch.
"""
from __future__ import annotations

import time

import numpy as np

from qbsbench.harness import Window
from qbsbench.trafficgen import WARMUP_STREAM, HostGraph, batch_pairs


def _warmup_pairs(system, traffic, hg, seed, chunk):
    us, vs = batch_pairs(traffic, hg, seed, 0, stream=WARMUP_STREAM)
    lm = system.landmarks
    x = int(np.flatnonzero(~system.is_landmark)[0])
    us = np.concatenate([us[:chunk], [lm[0], lm[1], x]]).astype(np.int32)
    vs = np.concatenate([vs[:chunk], [lm[1], x, x]]).astype(np.int32)
    return us, vs


def run(system, traffic: dict, seed: int, seconds: float, rec) -> Window:
    index = system.index
    hg = HostGraph(system.edges, system.n_vertices)
    svc = index.make_service(**traffic.get("service", {}))
    svc.query_batch(*_warmup_pairs(system, traffic, hg, seed, svc.chunk))
    rec.synchronize()

    rec.reset_counters()
    lanes0 = list(svc.lane_served)
    launches0 = system.launches()
    answers = []
    rec.setup_done()
    t0 = time.perf_counter()
    i = 0
    while True:
        us, vs = batch_pairs(traffic, hg, seed, i)
        if rec.trace and i == 1:
            with rec.profiled():
                res = svc.query_batch(us, vs)
        else:
            with rec.span("query_batch"):
                res = svc.query_batch(us, vs)
        answers += [(r.u, r.v, r.dist, r.edge_ids) for r in res]
        i += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds and (i >= 2 or not rec.trace):
            break
    rec.raw["lane_served"] = [b - a for a, b in zip(lanes0, svc.lane_served)]
    rec.raw["launches"] = {k: v - launches0[k] for k, v in system.launches().items()}
    return Window(attempted=len(answers), answers=answers,
                  metrics={"qps": len(answers) / elapsed},
                  notes=[f"window: {i} batches of {traffic['batch']} pairs, "
                         f"{len(answers)} queries in {elapsed:.3f} s"])
