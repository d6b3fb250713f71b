"""Where ``QbSIndex.apply_update`` spends its time on the card: build the
1.1 M-vertex hybrid index of ``chip_smoke.py``, choose its incremental
update batch, and print a cProfile of two ``apply_update`` calls (sorted by
cumulative time).

    python3 scripts/profile_apply_update.py            # on a machine with the card
    python3 scripts/profile_apply_update.py --n-vertices 200000
"""
from __future__ import annotations

import argparse
import cProfile
import pstats
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-vertices", type=int, default=1_100_000)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    from repro_torch import core

    g = core.barabasi_albert_graph(args.n_vertices, 3, seed=0)
    idx = core.QbSIndex.build(g, landmarks=core.select_landmarks(g, 20),
                              backend="hybrid")
    ins, dels, _ = chip_smoke.incremental_batch(core, idx, np.random.default_rng(3))
    for _ in range(2):
        prof = cProfile.Profile()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prof.enable()
        new = idx.apply_update(inserts=ins, deletes=dels)
        torch.cuda.synchronize()
        prof.disable()
        print(f"apply_update {time.perf_counter() - t0:.2f} s, "
              f"n_affected {new.last_update_info['n_affected']}", flush=True)
        pstats.Stats(prof).sort_stats("cumulative").print_stats(30)
    return 0


if __name__ == "__main__":
    sys.exit(main())
