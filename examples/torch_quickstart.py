"""Quickstart on the PyTorch/CUDA port: build a QbS index and answer
shortest-path-graph queries (the twin of ``examples/quickstart.py``).

  PYTHONPATH=src python examples/torch_quickstart.py                # the CUDA card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu   # plain torch
"""
import argparse

import numpy as np

from repro_torch.core import QbSIndex, from_edges
from repro_torch.core.baselines import bfs_spg

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the card)")
args = ap.parse_args()

# The paper's Figure 3 graph (1-indexed in the paper).
edges = np.array([(1, 2), (1, 3), (2, 4), (2, 5), (2, 6), (3, 4), (5, 6), (5, 7)]) - 1
graph = from_edges(edges, 7, device=args.device)

# Offline: labelling scheme (Algorithm 2) with 2 landmarks.
index = QbSIndex.build(graph, n_landmarks=2, device=args.device)
print("landmarks:", index.scheme.landmarks.tolist())
print("meta-graph d_M:\n", index.scheme.meta_dist.cpu().numpy())

# Online: SPG(3, 7) -> the sketch bounds the guided search (Algorithms 3+4).
res = index.query(2, 6)  # paper's SPG(3,7), 0-indexed
print(f"\nSPG(3,7): distance={res.dist}")
print("edges:", sorted((a + 1, b + 1) for a, b in res.edge_pairs(graph)))

oracle = bfs_spg(graph, 2, 6, device=args.device)
assert res.edge_pairs(graph) == oracle.edge_pairs(graph)
print("matches the two-BFS oracle: OK")

# Batched serving: many queries per call.
us, vs = np.array([0, 1, 3]), np.array([6, 6, 5])
for r in index.query_batch(us, vs):
    print(f"SPG({r.u + 1},{r.v + 1}): d={r.dist}, |E|={r.edge_ids.size // 2}")
