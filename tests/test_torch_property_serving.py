"""The serving fuzz harness of ``tests/test_property_serving.py`` on the
port: randomized arrival traces through ``repro_torch``'s
``StreamingService`` on its ``QbSIndex`` (CPU).

The drivers (``helpers/torch_traces.py``) are the reference harness's with
the package as a parameter.  Each example checks the harness's invariants
on the port (bit-identity with the numpy serving oracle, every future
resolved, duplicates identical, deadline bounds in simulated time,
accounting, the metrics snapshot), then runs the same trace through the JAX
package and requires the same answers, classes, epochs and stats.  The
seed sweeps are the reference's: 56 stream traces here with the
hypothesis driver, 18 update traces in ``test_torch_property_updates.py``
and 14 replica traces in ``test_torch_property_replicas.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from helpers.torch_traces import SCALE, run_trace  # noqa: E402


@pytest.mark.parametrize("seed", range(56 * SCALE))
def test_streaming_trace_properties(seed):
    assert run_trace("port", seed) == run_trace("ref", seed)


try:
    from hypothesis import given, settings, strategies as hyp_st
    _HAVE_HYPOTHESIS = True
except ImportError:                             # container without the extra:
    _HAVE_HYPOTHESIS = False                    # the sweep above still runs


if _HAVE_HYPOTHESIS:

    @given(seed=hyp_st.integers(min_value=0, max_value=2**31 - 1),
           n_ops=hyp_st.integers(min_value=1, max_value=40))
    @settings(max_examples=25 * SCALE, deadline=None)
    def test_streaming_trace_properties_hypothesis(seed, n_ops):
        assert run_trace("port", seed, n_ops=n_ops) == \
            run_trace("ref", seed, n_ops=n_ops)
