"""The knee sweep of an open-loop cell: set the cell up once, then offer
its traffic at each given rate for the given seconds, through a fresh
stream each time, and print one JSON line per window: latency quantiles from
the due time, how late the client ran, and whether the backlog grew (the
p95 of the window's last third against its first third, and the requests
still unresolved when the last arrival was due).  The knee is the highest
rate whose backlog does not grow and whose p95 meets the limit; the cell
runs at 0.8 of it.  Benchmark runs never run this.

    python3 qbsbench/sweep.py --config youtube-r20 --traffic hub-stream --seeds 5 \
        --seconds 15 --rates 60,80,100,120,140
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seeds", required=True, help="the traffic's seeds, run at each rate")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--reps", type=int, default=1)
    args = ap.parse_args()

    import numpy as np
    import torch

    from qbsbench import harness
    from qbsbench.trafficgen import HostGraph, stream_schedule

    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 3
    cfg = harness.load_json("configs", args.config)
    traffic = harness.load_json("traffic", args.traffic)
    driver = harness.load_module("drivers", traffic["driver"])
    seeds = [int(s) for s in args.seeds.split(",")]
    rec = harness.Recorder(False, T_START, ["cuda:0"])
    system = harness.load_module("systems", cfg["system"]).setup(cfg, seeds[0], "cuda", rec)
    hg = HostGraph(system.edges, system.n_vertices)
    driver.warm_up(system, traffic, seeds[0], rec)
    classes = [q["name"] for q in traffic["qos"]]
    runs = [(float(r), s) for r in args.rates.split(",") for s in seeds
            for _ in range(args.reps)]
    for rate, seed in runs:
        sched = stream_schedule(traffic, hg, seed, args.seconds, rate=rate)
        stream = driver.make_stream(system.index, traffic)
        futs, due, subm, done = driver.drive(stream, sched, classes)
        lat = np.where(np.isfinite(done), done - due, np.inf)
        third = max(1, lat.size // 3)
        t_end = due[-1]
        q = driver.quantile_ms
        print(json.dumps({
            "rate": rate, "seed": seed, "n": int(lat.size),
            "completed_per_s": float(lat.size / (np.nanmax(done) - (due[0] - sched["t"][0]))),
            "p50_ms": q(lat, 50), "p75_ms": q(lat, 75), "p90_ms": q(lat, 90),
            "p95_ms": q(lat, 95), "p99_ms": q(lat, 99),
            "p95_first_third_ms": q(lat[:third], 95),
            "p95_last_third_ms": q(lat[-third:], 95),
            "late_p50_ms": q(subm - due, 50), "late_p99_ms": q(subm - due, 99),
            "unresolved_at_last_arrival": int((~(done <= t_end)).sum()),
            "stats": dict(stream.stats)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
