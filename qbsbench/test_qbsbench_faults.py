"""``correct`` on the CPU, at a size a test run holds: a run drives the rest
of the harness (no look for a card) with the timed path broken underneath
and must come out not correct, once for each fault a serving cell can
have (an answer altered where it is produced; half of a chunk left out);
sound runs come out correct; and the control (the reference answering on
G-, without the paths through landmarks) comes out not correct.  A state
returned unchanged is training's fault and applies to no cell; the
several-chip fault, a missing exchange, is planted in the sharded
deployment by ``test_qbsbench_sharded.py``."""
import numpy as np
import pytest
import torch

from qbsbench import control, graphgen, harness

SPEC = harness.load_benchmark()
# the benchmark's cell beside the stream and walk mixes, which no cell runs
# yet: their drivers are judged alike
SPEC["workloads"] += [
    {"name": "youtube-r20.hub-stream", "config": "youtube-r20", "traffic": "hub-stream",
     "chips": 1},
    {"name": "skitter-r20.local-batch", "config": "skitter-r20", "traffic": "local-batch",
     "chips": 1}]
CELLS = ["youtube-r20.uniform-batch", "youtube-r20.hub-stream", "skitter-r20.local-batch"]


def _run(cell_name, seed=11, seconds=0.5):
    cell = harness.cell_of(SPEC, cell_name)
    cfg = harness.load_json("configs", cell["config"])
    cfg["graph"] = graphgen.scaled(cfg["graph"], 2500)
    return harness.run_cell(SPEC, cell_name, seed, seconds, False, "cpu", 0.0,
                            config=cfg, log=lambda s: None)


def _altered(orig):
    def serve_step(index, us, vs):
        dist, mask = orig(index, us, vs)
        mask = mask.clone()
        mask[0] = ~mask[0]
        return dist, mask
    return serve_step


def _half_left_out(orig):
    def serve_step(index, us, vs):
        h = max(1, us.shape[0] // 2)
        dist, mask = orig(index, us[:h], vs[:h])
        rest = us.shape[0] - h
        return (torch.cat([dist, dist.new_full((rest,), 1 << 20)]),
                torch.cat([mask, mask.new_zeros((rest, mask.shape[1]))]))
    return serve_step


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_are_correct(cell):
    out = _run(cell)
    assert out["correct"] is True and out["attempted"] > 0
    assert all(c["value"] == 0 for c in out["checks"].values())


@pytest.mark.parametrize("fault", [_altered, _half_left_out])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    from repro_torch.core import QbSIndex

    monkeypatch.setattr(QbSIndex, "serve_step", fault(QbSIndex.serve_step))
    out = _run(cell)
    assert out["correct"] is False
    assert out["checks"]["wrong_edges"]["value"] > 0


def test_a_lost_answer_is_missing(monkeypatch):
    from repro_torch.serving import QueryFuture

    orig = QueryFuture._resolve
    first = []

    def _resolve(fut, *a):
        if not first:          # the first answer never arrives
            first.append(fut)
            return
        orig(fut, *a)

    monkeypatch.setattr(QueryFuture, "_resolve", _resolve)
    out = _run("youtube-r20.hub-stream")
    assert out["correct"] is False and out["failed"] == 1


@pytest.mark.parametrize("cell", ["youtube-r20.uniform-batch", "youtube-r20.hub-stream"])
def test_the_control_is_not_correct(cell):
    w = harness.cell_of(SPEC, cell)
    cfg = harness.load_json("configs", w["config"])
    traffic = harness.load_json("traffic", w["traffic"])
    edges, n = graphgen.generate(graphgen.scaled(cfg["graph"], 3000))
    counts = control.control_counts(edges, n, traffic, 5, 0.5, 256,
                                    cfg["index"]["n_landmarks"])
    from qbsbench import judge
    ok, _ = judge.verdict(counts)
    assert not ok and counts["wrong_edges"] > 0 and counts["missing"] == 0


def test_control_landmarks_are_the_highest_degree_vertices():
    from repro_torch.core import from_edges, select_landmarks

    from qbsbench.reference import RefGraph

    edges = graphgen.chung_lu(2000, 5300, 60, 1, 8)
    want = select_landmarks(from_edges(edges, 2000, device="cpu"), 20)
    assert np.array_equal(control.landmarks_of(RefGraph(edges, 2000), 20), want)
