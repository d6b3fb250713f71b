"""QbS query-serving driver: build a labelling scheme for a graph and answer
batched shortest-path-graph queries.  Counterpart of
``repro.launch.serve`` on its single-device path.

  PYTHONPATH=src python -m repro_torch.launch.serve --graph ba --n 20000 \\
      --landmarks 20 --queries 200                      # on the CUDA card
  PYTHONPATH=src python -m repro_torch.launch.serve --n 2000 --device cpu

``--backend`` picks the relay (``segment``, ``csr`` or ``hybrid``);
``--device`` the device (the CUDA card by default; ``cpu`` runs each
kernel's plain PyTorch version).  ``--shards N`` builds the vertex-sharded
index instead (labels born sharded over an N-device mesh, every lane served
from the shards): the first N CUDA devices, or N shards on ``--device``
when one is named.  ``--replicas N`` serves through a consistent-hash
``ReplicaRouter`` over N streaming replicas (all on the one device), and
``--metrics-port P`` exports the Prometheus scrape endpoint on
``127.0.0.1:P`` (0 picks a free port; implies one replica).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..core import (
    INF,
    QbSIndex,
    barabasi_albert_graph,
    gnp_random_graph,
    labelling_size_bytes,
    packed_size_bytes,
    ring_of_cliques,
)
from ..core.frontier import BACKENDS
from ..core.graph import resolve_device
from ..core.mesh import Mesh


def build_graph(kind: str, n: int, seed: int, device=None):
    if kind == "ba":
        return barabasi_albert_graph(n, 3, seed=seed, device=device)
    if kind == "gnp":
        return gnp_random_graph(n, 6.0, seed=seed, device=device)
    if kind == "cliques":
        return ring_of_cliques(max(n // 8, 2), 8, seed=seed, device=device)
    raise ValueError(kind)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--graph", default="ba", choices=["ba", "gnp", "cliques"])
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--landmarks", type=int, default=20)
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="segment", choices=BACKENDS)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain PyTorch versions)")
    ap.add_argument("--shards", type=int, default=0,
                    help="build the vertex-sharded index over this many "
                         "devices (0 = replicated single-device index)")
    ap.add_argument("--replicas", type=int, default=0,
                    help="serve through a consistent-hash ReplicaRouter over "
                         "this many streaming replicas (0 = direct index "
                         "serving)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="export the metrics scrape endpoint on this port "
                         "(0 = pick an ephemeral port); implies at least one "
                         "streaming replica")
    args = ap.parse_args(argv)

    dev = resolve_device(None if args.device == "cuda" else args.device)
    g = build_graph(args.graph, args.n, args.seed, device=dev)
    print(f"[serve] graph {args.graph}: V={g.n_vertices} E={g.n_edges // 2}")

    t0 = time.perf_counter()
    if args.shards:
        mesh = args.shards if args.device == "cuda" else Mesh([dev] * args.shards)
        idx = QbSIndex.build(g, n_landmarks=args.landmarks, chunk=args.chunk,
                             sharded=mesh)
        t1 = time.perf_counter()
        info = idx.sharded_size_bytes()
        print(f"[serve] sharded labelling built in {t1 - t0:.2f}s over "
              f"{info['n_shards']} devices ({idx.labels.pack_dtype})")
        print(f"[serve] per-device bytes: "
              f"{info['per_device_bytes'] / 1e6:.2f}MB "
              f"(labels {info['per_device_label_bytes'] / 1e6:.2f}MB + CSR "
              f"{info['per_device_csr_bytes'] / 1e6:.2f}MB) = "
              f"{info['per_device_frac']:.2f}x of the replicated "
              f"{info['replicated_bytes'] / 1e6:.2f}MB")
    else:
        idx = QbSIndex.build(g, n_landmarks=args.landmarks, chunk=args.chunk,
                             backend=args.backend, device=dev)
        t1 = time.perf_counter()
        sz = labelling_size_bytes(idx.scheme)
        psz = packed_size_bytes(idx.packed)
        print(f"[serve] labelling built in {t1 - t0:.2f}s; "
              f"size(L)={sz['label_bytes'] / 1e6:.2f}MB "
              f"meta_edges={sz['n_meta_edges']}")
        print(f"[serve] packed tables: {psz['packed_bytes'] / 1e6:.2f}MB "
              f"({psz['dtype']}, {psz['ratio']:.1f}x smaller than int32)")

    rng = np.random.default_rng(args.seed)
    us = rng.integers(0, g.n_vertices, size=args.queries)
    vs = rng.integers(0, g.n_vertices, size=args.queries)

    n_replicas = args.replicas
    if args.metrics_port is not None and n_replicas == 0:
        n_replicas = 1
    router = server = None
    if n_replicas:
        from ..serving import MetricsRegistry, ReplicaRouter, serve_metrics
        router = ReplicaRouter(idx, n_replicas=n_replicas, cache_size=4096,
                               cache_policy="hub")
        print(f"[serve] replica tier: {n_replicas} replicas behind "
              f"consistent hashing")
        if args.metrics_port is not None:
            registry = MetricsRegistry()
            for i, rep in enumerate(router.replicas):
                registry.register(f"replica{i}", rep)
            server = serve_metrics(registry, port=args.metrics_port)
            print(f"[serve] metrics: http://127.0.0.1:"
                  f"{server.server_address[1]}/metrics")

    t2 = time.perf_counter()
    results = (router.query_batch(us, vs) if router is not None
               else idx.query_batch(us, vs))
    t3 = time.perf_counter()
    dists = np.array([r.dist for r in results], dtype=np.int64)
    sizes = np.array([r.edge_ids.size for r in results])
    print(f"[serve] {args.queries} queries in {t3 - t2:.2f}s "
          f"({(t3 - t2) / args.queries * 1e3:.2f} ms/query incl. host assembly)")
    finite = dists < INF
    if finite.any():
        print(f"[serve] dist: mean={dists[finite].mean():.2f} "
              f"max={dists[finite].max()}; SPG edges: mean={sizes.mean():.1f} "
              f"max={sizes.max()}")

    if router is not None:
        routed = router.stats["routed"]
        per_rep = {i: rep.stats["submitted"]
                   for i, rep in enumerate(router.replicas)}
        print(f"[serve] router: {routed} routed, per-replica {per_rep}")
        if server is not None:
            server.shutdown()
            server.server_close()
        router.close()


if __name__ == "__main__":
    main()
