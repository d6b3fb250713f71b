"""The vertex-sharded QbS deployment: the configuration's graph, handed to
the port as an edge list, and ``QbSIndex.build(..., sharded=mesh)``, a
``ShardedIndex`` whose packed labels and CSR lie one vertex block per card
of the cell (``rec.devices``); every lane answers from the shards, with
the halo exchange, an all-gather of bit-packed frontiers, at every level.

The configuration's ``index`` block gives ``shards`` (the cell's chips),
``n_landmarks``, ``chunk``, ``max_levels`` and ``max_chain``; the last two
must exceed the graph's diameter and longest recover chain, and are set
from the landmarks' measured eccentricity.

The edge list is kept under ``qbsbench/out/graphs/`` (``graphgen.cached``,
timed into ``graph_s``): a published-size graph takes minutes to draw,
which only a checkout's first run pays.  ``from_edges_s`` is the host CSR
construction (the
sharded build partitions on the host), ``build_s`` the build synchronised
over every card, ``labelling_s`` the distributed labelling
(``_run_labelling`` where ``core/distributed.py`` looks it up); a traced
run builds twice and times the second build, and wraps the serving calls
under the raw keys ``systems/qbs.py`` uses.

``in_memory_cell`` serves a one-device configuration in shards as a cell
that ``BENCHMARK.json`` does not hold (``run.py --shards``, the tests).
"""
from __future__ import annotations

import json
import time

import torch

from repro_torch.core import Mesh, QbSIndex, ShardedIndex, from_edges
from repro_torch.core import distributed as core_distributed

from qbsbench import control, graphgen, harness
from qbsbench.harness import BENCH
from qbsbench.reference import RefGraph
from qbsbench.systems.qbs import QbsSystem, build_index

GRAPHS = BENCH / "out" / "graphs"


def setup(config: dict, seed: int, device, rec) -> QbsSystem:
    ix = config["index"]
    mesh = Mesh(rec.devices)
    if mesh.n_shards != int(ix["shards"]):
        raise ValueError(f"the configuration has {ix['shards']} shards, the cell "
                         f"{mesh.n_shards} cards")
    t0 = time.perf_counter()
    edges, n = graphgen.cached(config["graph"], GRAPHS)
    rec.raw["graph_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = from_edges(edges, n, device="cpu")
    rec.raw["from_edges_s"] = time.perf_counter() - t0
    index = build_index(
        rec, lambda: QbSIndex.build(g, n_landmarks=int(ix["n_landmarks"]),
                                    sharded=mesh, chunk=int(ix["chunk"]),
                                    max_levels=int(ix["max_levels"]),
                                    max_chain=int(ix["max_chain"])),
        (core_distributed, "_run_labelling"), ShardedIndex)
    return QbsSystem(edges, n, index, index.labels.landmarks[0].cpu().numpy())


def in_memory_cell(bench: dict, like: str, shards: int, device, graph=None,
                   name=None, log=print) -> tuple[dict, str, dict]:
    """The cell ``like``'s configuration (its graph block updated by
    ``graph``, renamed ``name``) served by this deployment in ``shards``
    shards, under ``like``'s traffic, on ``shards`` chips: returns the
    benchmark that holds the cell (``harness.with_cell``), the cell's name
    and its configuration.  ``max_levels`` and ``max_chain`` come from the
    landmarks' eccentricity, which the reference's BFS measures on
    ``device``: every distance, sweep and recover chain is at most twice
    the largest landmark distance.  The graph is drawn, or found in the
    cache, here, so the cell's own set-up finds it cached."""
    base = harness.cell_of(bench, like)
    cfg = harness.load_json("configs", base["config"])
    cfg["graph"] = dict(cfg["graph"], **(graph or {}))
    t0 = time.perf_counter()
    edges, n = graphgen.cached(cfg["graph"], GRAPHS)
    graph_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    r = int(cfg["index"]["n_landmarks"])
    g = RefGraph(edges, n, device)
    ecc = int(g.bfs(torch.as_tensor(control.landmarks_of(g, r))).max())
    del g
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    depth = 2 * ecc + 1
    cfg.update(name=f"{name or cfg['name']}-sharded{shards}", system="qbs_sharded")
    cfg["index"] = {"shards": shards, "n_landmarks": r, "chunk": int(cfg["index"]["chunk"]),
                    "max_levels": depth, "max_chain": depth}
    cell = {"name": f"{cfg['name']}.{base['traffic']}", "config": cfg["name"],
            "traffic": base["traffic"], "chips": shards}
    log(f"in-memory cell {cell['name']}: {n} vertices, {edges.shape[0]} edges, "
        f"graph {graph_s:.3f} s, landmark eccentricity {ecc} in "
        f"{time.perf_counter() - t0:.3f} s, index {json.dumps(cfg['index'])}")
    return harness.with_cell(bench, cell, like), cell["name"], cfg
