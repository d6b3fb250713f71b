"""Run one cell of ``BENCHMARK.json`` once on the CUDA card:

    python3 qbsbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It generates the cell's inputs from the seed,
sets the system up, warms it up, measures for ``--seconds`` (``--trace 1``:
the per-layer metrics, with a profiled slice), checks every answer of the
window against the plain reference, and prints one JSON line last on
standard output; the numbers compared, each beside its limit, are the last
lines on standard error.  Without a CUDA card, or with fewer cards than
the cell asks for, it prints no result and exits with 3.

    python3 qbsbench/run.py --workload <name> --shards 4 [--graph <json>] \
        [--name <config>] --seed <n> --seconds <s> --trace <0|1>

runs, in the same way, a cell that ``BENCHMARK.json`` does not hold: the
cell ``<name>``'s configuration, its graph block updated by ``--graph``,
served vertex-sharded over that many cards (``systems/qbs_sharded.py``,
``in_memory_cell``) under the cell's traffic.  Drawing its graph (or
finding it cached) and measuring the landmarks' eccentricity come before
the run and are left out of its ``setup_s``; standard error gives their
times.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "qbsbench" / "out"
# kernel and build caches at fixed paths inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(OUT / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(OUT / "torch_extensions")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--shards", type=int, help="serve the cell's configuration "
                    "in this many shards, on as many cards")
    ap.add_argument("--graph", default="{}", help="with --shards: JSON that "
                    "updates the configuration's graph block")
    ap.add_argument("--name", help="with --shards: the configuration's name")
    args = ap.parse_args(argv)

    import torch

    from qbsbench import harness

    bench = harness.load_benchmark()
    need = args.shards or int(harness.cell_of(bench, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"qbsbench: the cell needs {need} CUDA card(s), {have} found; "
              "no result", file=sys.stderr)
        return 3
    workload, config, t_start = args.workload, None, T_START
    if args.shards:
        t0 = time.perf_counter()
        sharded = harness.load_module("systems", "qbs_sharded")
        bench, workload, config = sharded.in_memory_cell(
            bench, args.workload, args.shards, "cuda", json.loads(args.graph), args.name,
            log=lambda s: print(s, file=sys.stderr, flush=True))
        t_start += time.perf_counter() - t0
    out = harness.run_cell(bench, workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", t_start, config=config)
    found = harness.forbidden_modules()
    if found:
        print(f"qbsbench: loaded after the window: {found}; no result",
              file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
