"""The per-layer readers of kernel launches per general chunk
(``<kernel>.launches_per_chunk``): the window's launch counts over the
general chunks it dispatched, and no value without a ``launches`` dict or
without a general chunk.  ``side_attach``'s reader also gives no value
for a program that has no such kernel (the parent of the PR that added
it), where the relay's reads 0."""
import pytest

from qbsbench import harness

READERS = {"hybrid_relay.launches_per_chunk": ("hybrid_relay", 0),
           "side_attach.launches_per_chunk": ("side_attach", None)}


@pytest.mark.parametrize("name", READERS)
def test_launch_reader_arithmetic(name):
    kernel, without = READERS[name]
    read = harness.load_module("metrics", name).read
    launches = {"sketch_batch": 40, "hybrid_relay": 300, "side_attach": 48}
    assert read({"general_chunks": 8, "launches": launches}) == launches[kernel] / 8
    assert read({"general_chunks": 8, "launches": {**launches, kernel: 0}}) == 0
    assert read({"general_chunks": 8, "launches": {"sketch_batch": 8}}) == without
    assert read({"general_chunks": 8}) is None
    assert read({"general_chunks": 0, "launches": launches}) is None
    assert read({"launches": launches}) is None
