"""The control of ``correct``: the plain reference put in the program's
place, breaking one guarantee the configuration states.

The configurations state exact shortest-path graphs.  The control answers
as a search confined to G- would, the graph without the landmarks that QbS
searches outside of: for a pair with no landmark endpoint it returns the
shortest-path graph of the paths that avoid every landmark, so the paths
through landmarks, which the sketch and the recover closure supply, go
missing (and with them, where every shortest path runs through one, the
right distance).  Pairs with a landmark endpoint and ``u == v`` pairs are
answered exactly.  The judge must find it not correct.

It runs on the chip at a cell's own size, over the pairs a run of the cell
sends (``--answers`` of them, or a whole stream window), on each seed, and
prints one JSON line per seed with the judge's counts.  Benchmark runs
never run it.

    python3 qbsbench/control.py --workload youtube-r20.uniform-batch \
        --seeds 1,2,3 --seconds 20 --answers 3500
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from qbsbench import graphgen, harness, judge  # noqa: E402
from qbsbench.reference import UNREACHED, RefGraph, answer_pairs  # noqa: E402
from qbsbench.trafficgen import HostGraph, batch_pairs, stream_schedule  # noqa: E402


def landmarks_of(g: RefGraph, r: int) -> np.ndarray:
    """The ``r`` highest-degree vertices, ties by vertex id."""
    deg = g.degrees().cpu().numpy()
    return np.sort(np.argsort(-deg, kind="stable")[:r])


def control_answers(g: RefGraph, us, vs, landmarks) -> list:
    """``(u, v, dist, slots)`` per pair, answered on G- where neither end
    is a landmark."""
    us = np.asarray(us, np.int64)
    vs = np.asarray(vs, np.int64)
    blocked = np.zeros((g.n,), bool)
    blocked[landmarks] = True
    inner = ~blocked[us] & ~blocked[vs] & (us != vs)
    out: list = [None] * us.size
    for sel, blk in ((np.flatnonzero(inner), blocked), (np.flatnonzero(~inner), None)):
        for j, d, slots in answer_pairs(g, us[sel], vs[sel], blocked=blk):
            i = int(sel[j])
            out[i] = (int(us[i]), int(vs[i]),
                      judge.NO_PATH if d == UNREACHED else d, slots)
    return out


def cell_pairs(traffic: dict, hg: HostGraph, seed: int, seconds: float,
               answers: int):
    """The pairs a run of the cell sends: whole batches up to ``answers``
    queries, or the whole window of an open-loop schedule."""
    if "schedule" in traffic:
        s = stream_schedule(traffic, hg, seed, seconds)
        return s["u"], s["v"]
    us, vs, i = [], [], 0
    while sum(map(len, us)) < answers:
        u, v = batch_pairs(traffic, hg, seed, i)
        us.append(u)
        vs.append(v)
        i += 1
    return np.concatenate(us), np.concatenate(vs)


def control_counts(edges, n, traffic, seed, seconds, answers, n_landmarks,
                   device="cpu") -> dict:
    hg = HostGraph(edges, n)
    us, vs = cell_pairs(traffic, hg, seed, seconds, answers)
    g = RefGraph(edges, n, device)
    got = control_answers(g, us, vs, landmarks_of(g, n_landmarks))
    del g
    return judge.judge(edges, n, got, device)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--answers", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    bench = harness.load_benchmark()
    cell = harness.cell_of(bench, args.workload)
    cfg = harness.load_json("configs", cell["config"])
    traffic = harness.load_json("traffic", cell["traffic"])
    edges, n = graphgen.generate(cfg["graph"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        counts = control_counts(edges, n, traffic, seed, args.seconds, args.answers,
                                int(cfg["index"]["n_landmarks"]), "cuda")
        ok, _ = judge.verdict(counts)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": ok,
                          **counts, "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
