"""A four-chip cell on the CPU: the vertex-sharded deployment
(``systems/qbs_sharded.py``) on ``Mesh(["cpu"] * 4)``, run through
``run_cell`` as an in-memory cell of youtube-r20's graph at a size a test
run holds, comes out correct with every answer checked, and reports what
a one-chip cell reports; and with the halo exchange left out of its timed
path (each shard keeps only the frontier bits of its own vertex block) it
comes out not correct."""
import pytest

from qbsbench import graphgen, harness
from qbsbench.systems import qbs_sharded

LIKE = "youtube-r20.uniform-batch"


@pytest.fixture(autouse=True)
def _graphs_in_tmp(monkeypatch, tmp_path):
    """The deployment's graph cache in a test's own directory."""
    cached = graphgen.cached
    monkeypatch.setattr(graphgen, "cached", lambda spec, _: cached(spec, tmp_path))


@pytest.fixture
def cell():
    """The benchmark with the in-memory cell, its name and configuration."""
    small = graphgen.scaled(harness.load_json("configs", "youtube-r20")["graph"], 2500)
    return qbs_sharded.in_memory_cell(harness.load_benchmark(), LIKE, 4, "cpu",
                                      graph=small, log=lambda s: None)


def _run(cell, trace=False, seed=11):
    lines = []
    spec, name, cfg = cell
    out = harness.run_cell(spec, name, seed, 0.5, trace, "cpu", 0.0,
                           config=cfg, log=lines.append)
    return out, lines


@pytest.mark.parametrize("trace", [0, 1])
def test_four_shard_cell_is_correct(cell, trace):
    spec, name, cfg = cell
    assert name == "youtube-r20-sharded4.uniform-batch"
    assert harness.cell_of(spec, name)["chips"] == cfg["index"]["shards"] == 4
    out, lines = _run(cell, bool(trace))
    assert out["correct"] is True and out["failed"] == 0
    assert all(c["value"] == 0 for c in out["checks"].values())
    checked = next(s for s in lines if s.startswith("reference:")).split()[1]
    assert int(checked) == out["attempted"] >= 256          # every answer
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"} | (
        {"busy_s", "window_s"} if trace else set())
    applies = {m["name"] for m in spec["per_layer" if trace else "end_to_end"]
               if harness.applies(m, name)}
    assert applies == {m["name"] for m in spec["per_layer" if trace else "end_to_end"]
                       if harness.applies(m, LIKE)}
    assert set(out["metrics"]) <= applies
    assert set(out["metrics"]) >= ({"planner.general_share", "general_chunk_ms.batch",
                                    "labelling_s", "from_edges_s", "build_s"}
                                   if trace else {"qps", "peak_gib", "setup_s"})
    if trace:
        assert any(s.startswith("busy by card:") for s in lines)


def _own_block_only():
    """``core.distributed.Halo`` with the exchange between shards left
    out: each shard reads only the bits of its own block's sources."""
    from repro_torch.core.distributed import Halo

    class OwnBlockOnly(Halo):
        def __call__(self, masks, edges=None):
            out = super().__call__(masks, edges)
            for s in range(len(out)):
                word = self.word[s] if edges is None else self.word[s][edges[s]]
                out[s] = out[s] & (word // self.wloc == s)
            return out
    return OwnBlockOnly


def test_a_missing_exchange_is_not_correct(monkeypatch, cell):
    from repro_torch.core import sharded

    monkeypatch.setattr(sharded, "Halo", _own_block_only())  # the serving lanes' exchange
    out, _ = _run(cell)
    assert out["correct"] is False
    assert out["checks"]["wrong_edges"]["value"] > 0
