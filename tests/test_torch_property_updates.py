"""The update fuzz sweep of ``tests/test_property_serving.py`` on the port
(``repro_torch`` on the CPU), its first half: seeds 0-8 of the 18 traces
with mid-trace edge updates on a drawn relay backend, each future checked
against the per-epoch numpy oracle at the epoch it resolved under.  Each
example then runs through the JAX package and must give the same answers,
epochs, stats and final graph.  Seeds 9-17 are in
``test_torch_property_updates_late.py`` (the reference's side rebuilds its
compiled programs at every epoch, ~3 s a trace on this CPU, so the sweep
is split to keep each file near a minute).  Driver:
``helpers/torch_traces.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from helpers.torch_traces import UPDATE_SEEDS, run_update_trace  # noqa: E402


@pytest.mark.parametrize("seed", UPDATE_SEEDS[:len(UPDATE_SEEDS) // 2])
def test_update_trace_properties(seed):
    assert run_update_trace("port", seed) == run_update_trace("ref", seed)

