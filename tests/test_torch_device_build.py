"""The graph, its partition and its reverse-slot map, built by torch
operations (the path a CUDA device takes, run here on CPU tensors), held
to the reference.

``from_edges``, on seeded random edge lists with self-loops and
duplicates, unpadded and padded, equals the reference's
``repro.core.graph.from_edges`` bit for bit.  ``partition_graph``, on
``Mesh(["cpu"] * S)``, equals the reference's ``partition_edges`` for 1, 2
and 4 shards, each shard's blocks on its mesh device; and the sharded
index's global and reverse slot ids, built on the graph's device, equal a
numpy reverse map over the reference's partition.  Every comparison is
exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import distributed as jd  # noqa: E402
from repro.core import graph as jg  # noqa: E402
from repro_torch.core import distributed as td  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core.mesh import Mesh  # noqa: E402
from repro_torch.core.sharded import ShardedIndex  # noqa: E402
from helpers.serving_oracle import _reverse_edge_map as np_reverse  # noqa: E402

PADS = {"none": {}, "edges": {"pad_edges_to": 700},
        "both": {"pad_vertices_to": 90, "pad_edges_to": 800}}


def _edges(seed, n=80, m=300):
    """Random pairs with self-loops and repeats (both orientations)."""
    rng = np.random.default_rng(seed)
    e = rng.integers(0, n, (m, 2))
    e[:10, 1] = e[:10, 0]                       # self-loops
    e[10:30] = e[30:50][:, ::-1]                # reversed repeats
    return e


def _same(a: tg.Graph, b):
    """A port graph equals a reference graph, array for array."""
    for name in ("indptr", "src", "dst"):
        x, y = getattr(a, name), np.asarray(getattr(b, name))
        assert x.dtype == torch.int32 and y.dtype == np.int32, name
        assert np.array_equal(x.numpy(), y), name


@pytest.mark.parametrize("pad", sorted(PADS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_from_edges_device_path_equals_host_and_reference(seed, pad):
    e, kw = _edges(seed), PADS[pad]
    _same(tg.from_edges(e, 80, device="cpu", **kw), jg.from_edges(e, 80, **kw))
    # an int32 edge list is uploaded as it is and widened on the device
    _same(tg.from_edges(e.astype(np.int32), 80, device="cpu", **kw),
          jg.from_edges(e, 80, **kw))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_from_edges_device_path_edge_cases(dtype):
    empty = np.zeros((0, 2), dtype)
    _same(tg.from_edges(empty, 4, device="cpu"), jg.from_edges(empty, 4))
    loops = np.array([[1, 1], [2, 2]], dtype)
    _same(tg.from_edges(loops, 3, device="cpu", pad_edges_to=4),
          jg.from_edges(loops, 3, pad_edges_to=4))
    with pytest.raises(ValueError):
        tg.from_edges([[0, 1]], 3, pad_vertices_to=2, device="cpu")
    with pytest.raises(ValueError):
        tg.from_edges([[0, 1], [1, 2]], 3, pad_edges_to=2, device="cpu")


def _reference_partition(g: tg.Graph, s: int):
    return jd.partition_edges(jg.Graph(*(t.numpy() for t in g)), s)


GRAPHS = {
    "ba": lambda: tg.barabasi_albert_graph(400, 3, seed=4, device="cpu"),
    "gnp_padded": lambda: tg.gnp_random_graph(120, 3.0, seed=5, device="cpu",
                                              pad_vertices_to=128, pad_edges_to=512),
    "grid": lambda: tg.grid_graph(9, 7, device="cpu"),
}


@pytest.mark.parametrize("s", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_partition_graph_equals_host_partition(name, s):
    g = GRAPHS[name]()
    mesh = Mesh(["cpu"] * s)
    got = td.partition_graph(g, mesh)
    want = _reference_partition(g, s)
    assert (got.v_loc, got.e_max) == (want.v_loc, want.e_max)
    assert got.vstart.dtype == np.int32 and np.array_equal(got.vstart, want.vstart)
    for f in ("src", "dst_local", "eid"):
        blocks = getattr(got, f)
        assert len(blocks) == s
        for t, d, row in zip(blocks, mesh.devices, getattr(want, f)):
            assert t.device == d and t.dtype == torch.int32, f
            assert np.array_equal(t.numpy(), row), f
    host = got.host()
    for f in ("src", "dst_local", "eid"):
        assert np.array_equal(getattr(host, f), getattr(want, f)), f


@pytest.mark.parametrize("s", [1, 2, 4])
def test_sharded_slot_maps_equal_host_reverse_map(s):
    g = GRAPHS["gnp_padded"]()
    mesh = Mesh(["cpu"] * s)
    idx = ShardedIndex.build(g, n_landmarks=4, mesh=mesh)
    want = _reference_partition(g, s)
    rev = np_reverse(g.src.numpy(), g.dst.numpy(), g.n_vertices)
    rev_full = np.concatenate([rev, [g.n_edges]])
    assert idx.part.eid is None and idx.graph.device == torch.device("cpu")
    for k in range(s):
        assert np.array_equal(idx._eid_sh[k].numpy(), want.eid[k])
        assert np.array_equal(idx._rev_eid_sh[k].numpy(), rev_full[want.eid[k]])
        assert np.array_equal(idx.part.src[k].numpy(), want.src[k])
        assert idx.record.src_sh[k] is idx.part.src[k]         # placed once, shared
