"""End-to-end QbS serving on the PyTorch/CUDA port (the twin of
``examples/qbs_query_demo.py``): build the labelling of a hub-heavy graph,
inspect a sketch, answer a query batch through the planner/service stack,
re-query through the service's result cache, and cross-check a sample
against the exact two-BFS oracle.

  PYTHONPATH=src python examples/torch_qbs_query_demo.py                # the CUDA card
  PYTHONPATH=src python examples/torch_qbs_query_demo.py --device cpu   # plain torch
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import (
    INF,
    QbSIndex,
    barabasi_albert_graph,
    compute_sketch_batch,
    labelling_size_bytes,
)
from repro_torch.core.baselines import bfs_spg

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the card)")
ap.add_argument("--n", type=int, default=20_000, help="vertices")
args = ap.parse_args()

graph = barabasi_albert_graph(args.n, 3, seed=0, device=args.device)
print(f"graph: V={graph.n_vertices} E={graph.n_edges // 2} on {graph.device}")

t0 = time.time()
index = QbSIndex.build(graph, n_landmarks=20, backend="hybrid", device=args.device)
print(f"labelling built in {time.time() - t0:.2f}s; "
      f"size={labelling_size_bytes(index.scheme)['label_bytes'] / 1e3:.0f}KB "
      f"(graph: {graph.n_edges * 4 / 1e3:.0f}KB)")

# peek at one sketch (the fused sketch_batch kernel on the card)
u, v = 1234 % args.n, 8876 % args.n
rows = torch.as_tensor([u, v], device=graph.device)
lab = index.scheme.label_dist[rows]
sk = compute_sketch_batch(lab[:1], lab[1:], index.scheme.meta_w, index.scheme.meta_dist)
print(f"sketch for ({u},{v}): d_top={int(sk.d_top[0])} "
      f"d*_u={int(sk.d_star_u[0])} d*_v={int(sk.d_star_v[0])} "
      f"sketch_edges_u={int((sk.du_land[0] < INF).sum())}")

rng = np.random.default_rng(1)
us = rng.integers(0, graph.n_vertices, size=64)
vs = rng.integers(0, graph.n_vertices, size=64)
t0 = time.time()
results = index.query_batch(us, vs)   # the default service
dt = time.time() - t0
print(f"64 queries in {dt:.2f}s ({dt / 64 * 1e3:.1f} ms/query)")

# explicit service: planner lane stats + the canonical-pair result cache
service = index.make_service(async_depth=2, cache_size=1024)
service.query_batch(us, vs)
lanes = dict(zip(("trivial", "landmark_pair", "one_sided", "general"),
                 service.lane_served))
t0 = time.time()
service.query_batch(us, vs)           # repeat stream: all cache hits
dt_hot = time.time() - t0
print(f"planner lanes {lanes}; hot re-query {dt_hot / 64 * 1e6:.0f} us/query "
      f"(cache hits={service.cache.hits})")

for k in (0, 7, 13):
    r = results[k]
    o = bfs_spg(graph, r.u, r.v, device=args.device)
    status = "OK" if o.edge_pairs(graph) == r.edge_pairs(graph) else "MISMATCH"
    print(f"  SPG({r.u},{r.v}): d={r.dist} |edges|={len(r.edge_pairs(graph))} "
          f"oracle:{status}")
