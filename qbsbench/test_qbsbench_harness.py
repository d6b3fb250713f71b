"""The harness on the CPU: cells, configurations, traffic mixes and metrics
are found by name from their files; ``BENCHMARK.json`` keeps the
benchmark's rules; a run's last line has the contract's keys; a run
without a card prints no result; nothing under ``qbsbench/`` imports JAX
or the JAX package, and the reference imports nothing of the program; the
relay's byte count is the one the port's chip log printed; the trace's
reduction takes the union of device intervals."""
import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from qbsbench import graphgen, harness
from qbsbench.devtrace import reduce_events, short_name
from qbsbench.peaks import hybrid_relay_bytes

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def _small(cell):
    cfg = harness.load_json("configs", cell["config"])
    cfg["graph"] = graphgen.scaled(cfg["graph"], 2500)
    return cfg


def test_every_cell_finds_its_files_by_name():
    for w in SPEC["workloads"]:
        cfg_entry = next(c for c in SPEC["configs"] if c["name"] == w["config"])
        assert cfg_entry["file"] == f"qbsbench/configs/{w['config']}.json"
        cfg = harness.load_json("configs", w["config"])
        traffic = harness.load_json("traffic", w["traffic"])
        assert cfg["name"] == w["config"] and traffic["name"] == w["traffic"]
        assert cfg["reduced"] == cfg_entry["reduced"]
        assert hasattr(harness.load_module("systems", cfg["system"]), "setup")
        assert hasattr(harness.load_module("drivers", traffic["driver"]), "run")
    for m in SPEC["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)


def test_each_metric_lists_cells_that_report_what_it_moves():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS and harness.applies(e2e[m["moves"]], cell)
    for cell in CELLS:   # setup_s, another end-to-end metric, a per-layer one
        got = [m["name"] for m in SPEC["end_to_end"] if harness.applies(m, cell)]
        assert "setup_s" in got and len(got) >= 2
        assert any(harness.applies(m, cell) for m in SPEC["per_layer"])


def test_benchmark_file_keeps_the_rules():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["qbsbench"] and SPEC["command"][1].startswith("qbsbench/")
    assert 1 <= SPEC["run_seconds"] <= 51
    n = len(CELLS)
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names)) and all(NAME.match(x) for x in names)
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) == n
    assert all(w["chips"] == 1 and len(w["why"]) <= 200 for w in SPEC["workloads"])
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in SPEC["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert all("\n" not in x and len(x) <= 200 for x in layers)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]) and m["better"] in (
            "lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_has_the_contract_keys(trace):
    cell = harness.cell_of(SPEC, "youtube-r20.uniform-batch")
    out = harness.run_cell(SPEC, cell["name"], 3, 0.5, bool(trace), "cpu", 0.0,
                           config=_small(cell), log=lambda s: None)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[:5] == keys and list(out)[-1] == "checks"
    assert set(out) - set(keys) - {"checks"} <= ({"breakdown"} if trace else set())
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 256
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    want = ({m["name"] for m in SPEC["per_layer"] if harness.applies(m, cell["name"])}
            if trace else {"qps", "peak_gib", "setup_s"})
    assert set(out["metrics"]) <= want
    if not trace:
        assert set(out["metrics"]) == want
    assert all(set(v) == {"value", "unit"} for v in out["metrics"].values())
    assert {k: v["limit"] for k, v in out["checks"].items()} == {
        "missing": 0, "wrong_dist": 0, "wrong_edges": 0}
    json.dumps(out)


def test_a_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "qbsbench/run.py", "--workload",
                        "youtube-r20.uniform-batch", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package_imports(path):
    tops = {n.split(".")[0] for n in _imports(path)}
    assert not tops & set(harness.FORBIDDEN)
    if path != Path(__file__).resolve():    # this file names what it looks for
        text = path.read_text()
        assert not re.search(r"chip_smoke|BENCH(_BASELINE)?\.json|benchmarks/", text)


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert tops <= {"__future__", "warnings", "numpy", "torch"}, path


def test_relay_bytes_match_the_chip_log():
    # G- at K = 32 on the 1.1 M-vertex graph: 6,542,668 tail slots, 128 hubs,
    # a 128 x 4-word hub block; the port's chip log printed 100,973,236 bytes
    assert hybrid_relay_bytes(32, 1_100_000, 6_542_668, 128, 128 * 4) == 100_973_236


def _ev(name, a, b, cuda):
    dt = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, device_type=dt,
                           time_range=SimpleNamespace(start=a, end=b))


def test_trace_reduction_takes_the_union_of_device_intervals():
    events = [_ev("qbsbench.slice", 0, 100, False),
              _ev("qbsbench.general_step", 0, 60, False),
              _ev("aten::nonzero", 70, 90, False),
              _ev("void ns::(anonymous namespace)::pull_kernel<true>(int)", 10, 30, True),
              _ev("void at::native::elementwise_kernel<4>(int)", 20, 40, True),
              _ev("Memcpy DtoH (Device -> Pageable)", 50, 55, True)]
    r = reduce_events(events, 100e-6)
    assert r["busy_s"] == pytest.approx(35e-6)
    assert r["window_s"] == 100e-6
    assert r["kernel_device_s"]["pull_kernel"] == pytest.approx(20e-6)
    gaps = dict(r["breakdown"]["idle_gaps"])
    assert gaps["- / nonzero"] == pytest.approx(45e-6)          # 55-100
    assert gaps["qbsbench.general_step / python"] == pytest.approx(20e-6)   # 0-10, 40-50
    assert [n for n, _ in r["breakdown"]["device_ops"]][0] == "pull_kernel"


def test_short_names():
    assert short_name("void at::native::vectorized_elementwise_kernel<4, "
                      "at::native::FillFunctor<int>>(int, T)") == "vectorized_elementwise_kernel"
    assert short_name("aten::index_select") == "index_select"
