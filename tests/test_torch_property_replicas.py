"""The replica-tier fuzz sweep of ``tests/test_property_serving.py`` on the
port (``repro_torch`` on the CPU): 14 traces through a 3-replica
``ReplicaRouter`` with lockstep ``ManualClock``s and rolling drains and
restores, checked against the numpy oracle with per-replica accounting and
deadline bounds, then run through the JAX package: the same answers, router
stats and per-replica stats.  Driver: ``helpers/torch_traces.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from helpers.torch_traces import SCALE, run_router_trace  # noqa: E402


@pytest.mark.parametrize("seed", range(14 * SCALE))
def test_replica_router_trace_properties(seed):
    assert run_router_trace("port", seed) == run_router_trace("ref", seed)
