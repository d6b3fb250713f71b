"""The harness on the CPU: cells, configurations, traffic mixes and metrics
are found by name from their files; ``BENCHMARK.json`` keeps the
benchmark's rules; a run's last line has the contract's keys; a run
without a card prints no result; nothing under ``qbsbench/`` imports JAX
or the JAX package, and the reference imports nothing of the program; the
relay's byte count is the one the port's chip log printed; the trace's
reduction takes the union of device intervals, per card of the cell."""
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


def _shards(config: str) -> int:
    return int(harness.load_json("configs", config)["index"].get("shards", 1))


def chip_faults(workloads, shards=_shards) -> list[str]:
    """What breaks the rule on chips: each cell takes 1 or 4, at most
    ``max(1, n // 4)`` of the ``n`` cells take 4, and a cell's chips are
    its configuration's ``index.shards`` (1 where it states none)."""
    faults = [f"{w['name']}: {w['chips']} chips" for w in workloads
              if w["chips"] not in (1, 4)]
    four = sum(w["chips"] == 4 for w in workloads)
    if four > max(1, len(workloads) // 4):
        faults.append(f"{four} four-chip cells of {len(workloads)}")
    faults += [f"{w['name']}: {w['chips']} chips, {shards(w['config'])} shards"
               for w in workloads if w["chips"] != shards(w["config"])]
    return faults


def _cells(chips, shards=None):
    """Cells ``c0``, ``c1``, ... with these chips, each on its own
    configuration, whose shards are ``shards`` (the chips by default)."""
    shards = chips if shards is None else shards
    cells = [{"name": f"c{i}", "config": f"g{i}", "chips": c}
             for i, c in enumerate(chips)]
    return cells, lambda config: shards[int(config[1:])]


def test_chip_rule_accepts_one_four_chip_cell_with_four_shards():
    assert chip_faults(*_cells([1, 4])) == []
    assert chip_faults(*_cells([4] + [1] * 7)) == chip_faults(*_cells([4, 4] + [1] * 6)) == []


@pytest.mark.parametrize("chips, shards", [
    ([1, 2], None),                    # 2 chips
    ([4, 4, 4] + [1] * 5, None),       # a third four-chip cell of 8
    ([4, 4], None),                    # two of 2
    ([1, 4], [1, 1]),                  # four chips, one shard
    ([4, 1], [4, 4]),                  # one chip, four shards
])
def test_chip_rule_rejects(chips, shards):
    assert chip_faults(*_cells(chips, shards))


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
    assert chip_faults(SPEC["workloads"]) == []
    assert all(len(w["why"]) <= 200 for w in SPEC["workloads"])
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


def test_a_sharded_run_without_its_cards_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "qbsbench/run.py", "--workload",
                        "youtube-r20.uniform-batch", "--shards", "4", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "needs 4 CUDA card(s), 0 found" in p.stderr


def test_with_cell_lists_the_new_cell_where_the_like_cell_is():
    cell = {"name": "x.uniform-batch", "config": "x", "traffic": "uniform-batch",
            "chips": 4}
    spec = harness.with_cell(SPEC, cell, "youtube-r20.uniform-batch")
    assert spec["workloads"][-1] == cell and SPEC["workloads"][-1] != cell
    for k in ("end_to_end", "per_layer"):
        assert [harness.applies(m, "x.uniform-batch") for m in spec[k]] == [
            harness.applies(m, "youtube-r20.uniform-batch") for m in SPEC[k]]


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


def _ev(name, a, b, cuda, card=0):
    dt = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, device_type=dt, device_index=card,
                           time_range=SimpleNamespace(start=a, end=b))


def test_trace_reduction_takes_the_union_of_device_intervals():
    events = [_ev("qbsbench.slice", 0, 100, False),
              _ev("qbsbench.general_step", 0, 60, False),
              _ev("aten::nonzero", 70, 90, False),
              _ev("void ns::(anonymous namespace)::pull_kernel<true>(int)", 10, 30, True),
              _ev("void at::native::elementwise_kernel<4>(int)", 20, 40, True),
              _ev("Memcpy DtoH (Device -> Pageable)", 50, 55, True)]
    r = reduce_events(events, 100e-6, [0])
    assert r["busy_s"] == pytest.approx(35e-6)
    assert r["window_s"] == 100e-6
    assert r["kernel_device_s"]["pull_kernel"] == pytest.approx(20e-6)
    gaps = dict(r["breakdown"]["idle_gaps"])
    assert gaps["- / nonzero"] == pytest.approx(45e-6)          # 55-100
    assert gaps["qbsbench.general_step / python"] == pytest.approx(20e-6)   # 0-10, 40-50
    assert [n for n, _ in r["breakdown"]["device_ops"]][0] == "pull_kernel"


def test_trace_reduction_over_cards():
    events = [_ev("qbsbench.slice", 0, 100, False),
              _ev("qbsbench.general_step", 0, 100, False),
              _ev("void pull_kernel<true>(int)", 10, 30, True, card=0),
              _ev("void pull_kernel<true>(int)", 20, 40, True, card=0),
              _ev("void pull_kernel<true>(int)", 50, 90, True, card=1),
              _ev("Memcpy PtoP (Device -> Device)", 0, 5, True, card=1)]
    r = reduce_events(events, 100e-6, [0, 1])
    assert r["busy_s_by_card"] == pytest.approx({0: 30e-6, 1: 45e-6})
    assert r["busy_s"] == pytest.approx(37.5e-6)                   # the mean
    assert r["kernel_device_s"]["pull_kernel"] == pytest.approx(80e-6)   # the sum
    # idle where no card ran: 5-10, 40-50, 90-100
    assert dict(r["breakdown"]["idle_gaps"]) == pytest.approx(
        {"qbsbench.general_step / python": 25e-6})
    four = reduce_events(events, 100e-6, [0, 1, 2, 3])      # two cards idle
    assert four["busy_s"] == pytest.approx(75e-6 / 4)
    assert four["busy_s_by_card"][3] == 0
    # one card: every event counts on it, the union of all of them
    one = reduce_events(events, 100e-6, [0])
    assert one["busy_s"] == pytest.approx(75e-6) and list(one["busy_s_by_card"]) == [0]
    on_card0 = [_ev(e.name, e.time_range.start, e.time_range.end,
                    e.device_type == torch.autograd.DeviceType.CUDA) for e in events]
    assert one == reduce_events(on_card0, 100e-6, [0])


def test_short_names():
    assert short_name("void at::native::vectorized_elementwise_kernel<4, "
                      "at::native::FillFunctor<int>>(int, T)") == "vectorized_elementwise_kernel"
    assert short_name("aten::index_select") == "index_select"
