"""The per-layer metrics read from the program's own tracer
(``repro_torch.trace``) on the CPU: a traced run reports the counter
metrics and no device-ms metric (the CPU records no CUDA event); a run
with tracing off records nothing; each reader's arithmetic on a report
with device times; no value from a program without the tracer; and the
trace's reduction names an idle gap by a ``qbs.*`` span nested inside the
harness's span without counting the span as a device operation."""
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import repro_torch
from qbsbench import graphgen, harness
from qbsbench.devtrace import reduce_events
from repro_torch import trace

ROOT = Path(__file__).resolve().parents[1]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = ["youtube-r20.uniform-batch", "skitter-r20.uniform-batch"]
DEVICE_MS = {"general.chunk_device_ms": "serve_step", "general.sketch_ms": "sketch",
             "general.bfs_ms": "search.bfs", "general.reverse_ms": "search.reverse",
             "general.attach_ms": "search.attach", "general.delta_ms": "search.delta",
             "general.symmetrize_ms": "symmetrize"}
COUNTERS = {"general.bfs_levels_per_chunk": "search.bfs_levels",
            "general.closure_steps_per_chunk": "search.closure_steps",
            "general.host_syncs_per_chunk": "search.host_syncs"}
HOST = {"general.recover_row_share", "drain.host_ms_per_chunk"} | set(COUNTERS)
NEW = set(DEVICE_MS) | HOST


def _read(name):
    return harness.load_module("metrics", name).read({})


def test_new_metrics_are_declared_for_both_cells():
    got = {m["name"]: m for m in SPEC["per_layer"] if m["name"] in NEW}
    assert set(got) == NEW
    for name, m in got.items():
        assert m["workloads"] == CELLS and m["moves"] == "qps" and m["better"] == "lower"
        assert m["source"] == ("program_counter" if name in COUNTERS
                               or name == "general.recover_row_share" else "program_span")


def _small_run(trace_on: bool):
    cell = harness.cell_of(SPEC, CELLS[0])
    cfg = harness.load_json("configs", cell["config"])
    cfg["graph"] = graphgen.scaled(cfg["graph"], 2500)
    return harness.run_cell(SPEC, cell["name"], 5, 0.5, trace_on, "cpu", 0.0,
                            config=cfg, log=lambda s: None)


def test_traced_run_reports_counters_and_no_device_ms():
    trace.reset()
    out = _small_run(True)
    got = set(out["metrics"]) & NEW
    assert got == HOST
    r = trace.report()
    chunks = r["spans"]["serve_step"]["calls"]
    assert chunks >= 8          # the profiled batch of 256 pairs, chunk 32
    levels = out["metrics"]["general.bfs_levels_per_chunk"]["value"]
    assert levels == r["counters"]["search.bfs_levels"] / chunks >= 1
    assert 0 <= out["metrics"]["general.recover_row_share"]["value"] <= 100
    assert out["metrics"]["drain.host_ms_per_chunk"]["unit"] == "ms"
    assert out["breakdown"]["device_ops"] == []     # no device, no span counted as one


def test_untraced_run_records_nothing():
    trace.reset()
    _small_run(False)
    assert trace.report() == {"spans": {}, "counters": {}, "records": []}
    assert all(_read(name) is None for name in NEW)


def _fake_report(with_events=True):
    ms = (lambda x: x) if with_events else (lambda x: None)
    spans = {"serve_step": {"calls": 4, "host_ms": 900.0, "device_ms": ms(880.0)},
             "sketch": {"calls": 4, "host_ms": 1.0, "device_ms": ms(0.4)},
             "search.bfs": {"calls": 4, "host_ms": 100.0, "device_ms": ms(80.0)},
             "search.reverse": {"calls": 4, "host_ms": 50.0, "device_ms": ms(40.0)},
             "search.attach": {"calls": 8, "host_ms": 700.0, "device_ms": ms(700.0)},
             "symmetrize": {"calls": 4, "host_ms": 2.0, "device_ms": ms(8.0)},
             "drain": {"calls": 5, "host_ms": 10.0, "device_ms": ms(5.0)}}
    counters = {"search.bfs_levels": 36, "search.closure_steps": 20,
                "search.host_syncs": 140, "search.rows": 128, "search.recover_rows": 112}
    return {"spans": spans, "counters": counters, "records": []}


def test_readers_per_chunk_arithmetic(monkeypatch):
    monkeypatch.setattr(trace, "report", _fake_report)
    want = {"general.chunk_device_ms": 220.0, "general.sketch_ms": 0.1,
            "general.bfs_ms": 20.0, "general.reverse_ms": 10.0,
            "general.attach_ms": 175.0, "general.delta_ms": 0.0,   # no delta span
            "general.symmetrize_ms": 2.0, "general.bfs_levels_per_chunk": 9.0,
            "general.closure_steps_per_chunk": 5.0,
            "general.host_syncs_per_chunk": 35.0, "general.recover_row_share": 87.5,
            "drain.host_ms_per_chunk": 2.0}
    assert {n: pytest.approx(v) for n, v in want.items()} == {n: _read(n) for n in NEW}
    monkeypatch.setattr(trace, "report", lambda: _fake_report(False))
    assert all(_read(n) is None for n in DEVICE_MS)
    assert all(_read(n) is not None for n in HOST)


def test_readers_without_a_tracer_give_no_value(monkeypatch):
    monkeypatch.delattr(repro_torch, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    assert all(_read(name) is None for name in NEW)


def _ev(name, a, b, cuda, annotation=False):
    dt = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, device_type=dt, is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=a, end=b))


def test_idle_gap_named_by_the_program_span():
    events = [_ev("qbsbench.slice", 0, 100, False, True),
              _ev("qbsbench.general_step", 0, 90, False, True),
              _ev("qbs.serve_step", 2, 88, False, True),
              _ev("qbs.search.bfs", 5, 60, False, True),
              _ev("aten::nonzero", 40, 56, False),
              _ev("cudaStreamSynchronize", 41, 55, False),
              # the device-side copies of the annotations are not operations
              _ev("qbs.serve_step", 3, 89, True, True),
              _ev("qbs.search.bfs", 6, 59, True, True),
              _ev("void at::native::index_elementwise_kernel<128, 4>(int)", 10, 40, True),
              _ev("void at::native::elementwise_kernel<4>(int)", 60, 80, True),
              _ev("Memcpy DtoH (Device -> Pageable)", 86, 100, True)]
    r = reduce_events(events, 100e-6, [0])
    assert r["busy_s"] == pytest.approx(64e-6)
    ops = [n for n, _ in r["breakdown"]["device_ops"]]
    assert ops == ["index_elementwise_kernel", "elementwise_kernel", "Memcpy DtoH"]
    assert not any(n.startswith("qbs") for n in r["kernel_device_s"])
    gaps = dict(r["breakdown"]["idle_gaps"])
    assert gaps == pytest.approx({
        "qbs.search.bfs / python": 10e-6,                   # 0-10
        "qbs.search.bfs / cudaStreamSynchronize": 20e-6,    # 40-60
        "qbs.serve_step / python": 6e-6})                   # 80-86
