"""The reader of the sharded attach's closure steps
(``metrics/sharded_attach.closure_steps_per_chunk.py``): declared for the
four-card cell alone, moving ``qps``; steps per sharded chunk from the
tracer's report; no value without a sharded chunk or without the counter,
which a program without the kernels (or the plain loop on the CPU) never
counts."""
import json
from pathlib import Path

import pytest

from qbsbench import harness
from repro_torch import trace

SPEC = json.loads((Path(__file__).resolve().parents[1] / "BENCHMARK.json").read_text())
NAME = "sharded_attach.closure_steps_per_chunk"


def _read():
    return harness.load_module("metrics", NAME).read({})


def test_declared_for_the_four_card_cell():
    (m,) = [m for m in SPEC["per_layer"] if m["name"] == NAME]
    assert m["workloads"] == ["orkut-r20-sharded4.uniform-batch"]
    assert (m["moves"], m["source"], m["better"], m["unit"]) == (
        "qps", "program_counter", "lower", "steps")
    assert m["layer"] == "core/sharded.py general_lane"


@pytest.mark.parametrize("spans,counters,want", [
    ({"sharded.serve_step": {"calls": 4}}, {"sharded.closure_steps": 10}, 2.5),
    ({"sharded.serve_step": {"calls": 4}}, {"sharded.closure_steps": 0}, 0.0),
    ({"sharded.serve_step": {"calls": 4}}, {"sharded.host_syncs": 9}, None),
    ({"serve_step": {"calls": 4}}, {"sharded.closure_steps": 10}, None),
])
def test_reader_per_chunk(monkeypatch, spans, counters, want):
    monkeypatch.setattr(trace, "report", lambda: {"spans": spans, "counters": counters,
                                                 "records": []})
    assert _read() == want
