"""Lower reduced cells of the reference's dry run on a (2, 2) data/model
mesh of forced host devices, and print what the port's dry run is held to,
as one JSON object on the last line of standard output.

    PYTHONPATH=src python tests/helpers/dryrun_ref_check.py [GROUP,...]

GROUP is ``dense`` (the dense config's cells and variants), ``families``
(the MoE, recurrent and hybrid configs' cells), ``qbs`` or ``hlo`` (the
compiled text of ``tests/test_hlo_stats.py``'s real program, a ``psum``
under ``shard_map`` on one device); all four without an argument.

Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices
for the whole process, so this runs in a process of its own.  For every
cell: XLA's ``argument_size_in_bytes`` of the compiled step, its cost
analysis (``flops``, ``bytes_accessed``, ``transcendentals``), its
collective bytes by kind, and the partition specs the step was laid out
with (every spec tree handed to the reference's ``_shard_tree``, in order,
each leaf as ``[path, spec]``).  The QbS cells use a small graph added to
``GRAPHS`` in memory, and its sizes are printed too (``qbs_graph``), so
the port's side builds the same graph.
"""
from __future__ import annotations

import json
import sys
import time

import repro.launch.dryrun as D  # noqa: I001 — sets XLA_FLAGS before jax loads

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from repro.configs import get_config
from repro.configs.qbs_graphs import GraphScale
from repro.models.config import ShapeCell

B, S = 4, 64
LM_CASES = [
    # (name, arch, kind, batch, seq, variant); the group is the name's prefix
    ("dense-train", "qwen1.5-4b", "train", B, S, {}),
    ("dense-prefill", "qwen1.5-4b", "prefill", B, S, {}),
    ("dense-decode", "qwen1.5-4b", "decode", B, S, {}),
    ("dense-train-zero1", "qwen1.5-4b", "train", B, S, {"zero1": True}),
    ("dense-decode-kvq", "qwen1.5-4b", "decode", B, S, {"kv_quant": True}),
    ("dense-decode-kvseq", "qwen1.5-4b", "decode", B, S, {"kv_layout": "seq"}),
    ("moe-train", "phi3.5-moe-42b-a6.6b", "train", B, S, {}),
    ("moe-prefill", "phi3.5-moe-42b-a6.6b", "prefill", B, S, {}),
    ("moe-decode", "phi3.5-moe-42b-a6.6b", "decode", B, S, {}),
    ("ssm-train", "rwkv6-1.6b", "train", B, S, {}),
    ("ssm-prefill", "rwkv6-1.6b", "prefill", B, S, {}),
    ("ssm-decode", "rwkv6-1.6b", "decode", B, S, {}),
    ("ssm-decode-b1", "rwkv6-1.6b", "decode", 1, S, {}),
    ("hybrid-decode-b1", "zamba2-2.7b", "decode", 1, S, {}),
]
GRAPH = GraphScale("tiny", 1_000, 3_000, n_landmarks=4)
QBS_CASES = [
    ("qbs-label-bool", "label", {"frontier_mode": "bool"}),
    ("qbs-label-bitmap", "label", {"frontier_mode": "bitmap"}),
    ("qbs-label-pull", "label", {"frontier_mode": "pull"}),
    ("qbs-serve", "serve", {}),
    ("qbs-scale-serve", "scale-serve", {"batch": 8}),
]


def _key(entry):
    for attr in ("key", "idx", "name"):
        if hasattr(entry, attr):
            return getattr(entry, attr)
    return str(entry)


def _spec(spec):
    return [list(d) if isinstance(d, tuple) else d for d in spec]


def flat_specs(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return [[[_key(e) for e in path], _spec(s)] for path, s in leaves]


def main() -> None:
    groups = set(sys.argv[1].split(",")) if len(sys.argv) > 1 else \
        {"dense", "families", "qbs", "hlo"}
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    seen: list = []
    orig = D._shard_tree

    def recording(mesh_, spec_tree):
        seen.append(flat_specs(spec_tree))
        return orig(mesh_, spec_tree)

    D._shard_tree = recording
    out: dict = {"mesh": {"data": 2, "model": 2}, "lm": {}, "qbs": {}}
    for name, arch, kind, b, s, variant in LM_CASES:
        if ("dense" if name.startswith("dense") else "families") in groups:
            cfg = get_config(arch).reduced()
            shape = ShapeCell(name, kind, s, b)
            seen.clear()
            t0 = time.perf_counter()
            with mesh:
                stats = D._lower_lm_once(cfg, shape, mesh, **variant)
            out["lm"][name] = {
                "arch": arch, "kind": kind, "batch": b, "seq": s, "variant": variant,
                "argument_bytes": stats["memory"]["argument_bytes"],
                "flops": stats["flops"], "bytes_accessed": stats["bytes_accessed"],
                "transcendentals": stats["transcendentals"],
                "collectives": stats["collectives"], "specs": list(seen),
                "seconds": time.perf_counter() - t0}
    if "qbs" in groups:
        D.GRAPHS[GRAPH.name] = GRAPH
        out["qbs_graph"] = [GRAPH.name, GRAPH.n_vertices, GRAPH.n_edges_undirected,
                            GRAPH.n_landmarks]
        lower = {"label": D.lower_qbs_labelling_cell, "serve": D.lower_qbs_serve_cell,
                 "scale-serve": D.lower_qbs_scale_serve_cell}
        for name, kind, kw in QBS_CASES:
            t0 = time.perf_counter()
            with mesh:
                stats = lower[kind](GRAPH.name, mesh, **kw)
            out["qbs"][name] = {
                "kind": kind, "kw": kw, "argument_bytes": stats["memory"]["argument_bytes"],
                "collectives": stats["collectives"], "variant": stats["variant"],
                "graph": stats["graph"], "seconds": time.perf_counter() - t0}
    if "hlo" in groups:
        from repro.compat import shard_map

        one = Mesh(np.array(jax.devices()[:1]), ("x",))
        fn = jax.jit(shard_map(lambda a: jax.lax.psum(a, "x"), mesh=one,
                               in_specs=(P(),), out_specs=P()))
        out["hlo_text"] = fn.lower(
            jax.ShapeDtypeStruct((256,), jnp.float32)).compile().as_text()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
