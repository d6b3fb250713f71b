"""Shared set-up of the dry-run tests: the reference's compiled figures
from ``dryrun_ref_check.py`` (run in a process of its own, since importing
``repro.launch.dryrun`` sets ``XLA_FLAGS``), and the maps between the
reference's stacked spec trees and the port's per-layer ones.

Run as a module, it prints a markdown table of the reference's compiled
per-device figures beside the port's dry run on those reduced cells (a
(2, 2) data/model mesh): argument bytes (which the tests hold equal),
FLOPs and collective bytes side by side, with no gate.  The reference's
FLOPs are XLA's cost analysis of one device's partitioned program; the
port's are the meta trace's global count divided evenly over the four
devices.

    PYTHONPATH=src:tests python -m helpers.torch_dryrun
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

from repro_torch.configs import get_config
from repro_torch.configs.qbs_graphs import GraphScale
from repro_torch.core.mesh import NamedMesh
from repro_torch.launch import dryrun as D
from repro_torch.models.config import ShapeCell

HELPER = os.path.join(os.path.dirname(__file__), "dryrun_ref_check.py")
SRC = os.path.join(os.path.dirname(__file__), "..", "..", "src")


def run_reference(groups: str, timeout: int = 120) -> dict:
    """The helper's JSON for ``groups`` (``dense``, ``families``, ``qbs``,
    comma-separated)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([SRC, env.get("PYTHONPATH", "")])
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, HELPER, groups], env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def spec_tuple(spec) -> tuple:
    """A spec from JSON (lists for tuple entries) or a ``P`` as a tuple."""
    return tuple(tuple(d) if isinstance(d, list) else d for d in spec)


def port_leaves(tree, path=()) -> dict:
    """``{path: spec}`` of a port spec tree (dicts, lists, tuples, ``P``s)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(port_leaves(v, path + (k,)))
        return out
    if type(tree) in (list, tuple):
        out = {}
        for i, v in enumerate(tree):
            out.update(port_leaves(v, path + (i,)))
        return out
    return {} if tree is None else {path: tuple(tree)}


def layer_names(cfg, ref_path) -> list[tuple[str, int]]:
    """The port's parameter names of one reference parameter leaf (its key
    path), each with the number of stack dims the reference adds."""
    if ref_path[0] != "blocks":
        return [(".".join(ref_path), 0)]
    rest = ".".join(ref_path[1:])
    if cfg.family == "hybrid":
        return [(f"blocks.{i}.{j}.{rest}", 2)
                for i in range(cfg.n_layers // cfg.hybrid_period)
                for j in range(cfg.hybrid_period)]
    return [(f"blocks.{i}.{rest}", 1) for i in range(cfg.n_layers)]


def ref_cache_path(path: tuple) -> tuple:
    """The reference's cache path of a port cache leaf: the layer indices
    (one after ``layers`` / ``attn``, two after ``mamba``) dropped."""
    n = {"layers": 1, "attn": 1, "mamba": 2}.get(path[0], 0)
    return path[:1] + path[1 + n:]


def check_param_specs(cfg, ref_leaves, port_specs: dict) -> None:
    """Every reference parameter (or moment) spec against the port's under
    each of its per-layer names: the stack dims dropped, or kept where the
    port's spec spells them (zero1's layer-stack cut)."""
    seen = set()
    for path, spec in ref_leaves:
        spec = spec_tuple(spec)
        for name, n_stack in layer_names(cfg, tuple(path)):
            got = tuple(port_specs[name])
            want = spec if len(got) == len(spec) else spec[n_stack:]
            assert got == want, (name, got, spec)
            seen.add(name)
    assert seen == set(port_specs)


def check_tree_specs(ref_leaves, port_tree, cache: bool = False) -> None:
    """A batch or cache spec tree: every port leaf equals the reference's
    leaf at the same place, the stack dims dropped."""
    want = {tuple(p): spec_tuple(s) for p, s in ref_leaves}
    got = port_leaves(port_tree)
    for path, spec in got.items():
        ref = want[ref_cache_path(path) if cache else path]
        assert spec == ref[len(ref) - len(spec):], (path, spec, ref)
        assert all(d is None for d in ref[:len(ref) - len(spec)]), (path, ref)
    mapped = {ref_cache_path(p) if cache else p for p in got}
    assert mapped == set(want)


def mesh22():
    return NamedMesh(["meta"] * 4, ("data", "model"), (2, 2))


def port_cell(case: dict):
    cfg = get_config(case["arch"]).reduced()
    shape = ShapeCell("cell", case["kind"], case["seq"], case["batch"])
    return cfg, shape


def port_qbs_cell(ref: dict, case: dict) -> dict:
    """The port's QbS cell of one helper case, at the helper's graph."""
    cell = {"label": D.qbs_label_cell, "serve": D.qbs_serve_cell,
            "scale-serve": D.qbs_scale_serve_cell}[case["kind"]]
    return cell(GraphScale(*ref["qbs_graph"]), mesh22(), **case["kw"])


def check_lm_argument_bytes(case: dict) -> None:
    cfg, shape = port_cell(case)
    got = D.lm_cell(cfg, shape, mesh22(), **case["variant"])
    assert got["memory"]["argument_bytes"] == case["argument_bytes"]


def check_lm_specs(case: dict) -> None:
    """The spec trees the reference handed to its ``_shard_tree``, in order:
    train (params, {mu, nu, step}, batch); prefill (params, batch); decode
    (params, cache)."""
    cfg, shape = port_cell(case)
    v = case["variant"]
    lay = D.lm_layout(cfg, shape, mesh22(), kv_quant=v.get("kv_quant", False),
                      zero1=v.get("zero1", False), kv_layout=v.get("kv_layout", "hd"))
    specs = case["specs"]
    check_param_specs(cfg, specs[0], lay["pspec"])
    if shape.kind == "train":
        opt = {"mu": [], "nu": [], "step": []}
        for path, spec in specs[1]:
            opt[path[0]].append([path[1:], spec])
        check_param_specs(cfg, opt["mu"], lay["mom_spec"])
        check_param_specs(cfg, opt["nu"], lay["mom_spec"])
        assert [s for _, s in opt["step"]] == [[]]
        check_tree_specs(specs[2], lay["args"][2][1])
        assert len(specs) == 3
    elif shape.kind == "prefill":
        check_tree_specs(specs[1], lay["args"][1][1])
        assert len(specs) == 2
    else:
        check_tree_specs(specs[1], lay["c_spec"], cache=True)
        assert len(specs) == 2


def _coll(c: dict) -> str:
    kinds = {k: v for k, v in c.items() if k != "_counts"}
    return ", ".join(f"{k} {v}" for k, v in sorted(kinds.items())) or "none"


def main() -> None:
    ref = run_reference("dense,families,qbs", timeout=600)
    print("| cell | argument bytes, reference / port | FLOPs per device, reference "
          "/ port (even split) | collective bytes per device, reference | port |")
    print("|---|---|---|---|---|")
    for name, case in ref["lm"].items():
        cfg, shape = port_cell(case)
        got = D.lm_cell(cfg, shape, mesh22(), **case["variant"])
        print(f"| {name} | {case['argument_bytes']} / {got['memory']['argument_bytes']} "
              f"| {case['flops']:.0f} / {got['flops']:.0f} | {_coll(case['collectives'])} "
              f"| {_coll(got['collectives'])} |")
    for name, case in ref["qbs"].items():
        got = port_qbs_cell(ref, case)
        print(f"| {name} | {case['argument_bytes']} / {got['memory']['argument_bytes']} "
              f"| not compared | {_coll(case['collectives'])} "
              f"| {_coll(got['collectives'])} (one level) |")


if __name__ == "__main__":
    main()
