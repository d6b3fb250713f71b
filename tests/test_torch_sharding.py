"""The port's named meshes and partition specs (``repro_torch.core.mesh.
NamedMesh``, ``repro_torch.distributed.sharding``, ``repro_torch.launch.
mesh``): ``shard_tree`` cuts each tensor exactly as numpy slicing by the
spec cuts it, with the first axis of a tuple entry major (as a JAX
``NamedSharding`` does), and the production meshes build over the meta
device with no real device.  Every comparison is exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.mesh import Mesh, NamedMesh  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    P,
    dp_axes_of,
    local_mesh,
    named,
    shard_numel,
    shard_tree,
)
from repro_torch.launch.mesh import dp_axes, make_production_mesh  # noqa: E402

SPECS = [
    P(None, None),
    P("data", None),
    P(None, "model"),
    P("data", "model"),
    P("model", "data"),
    P(("pod", "data"), None),
    P(("data", "pod"), "model"),
    P(None, ("pod", "data", "model")),
]
SIZES = {"pod": 2, "data": 3, "model": 2}


def _numpy_block(a, spec, coords, sizes):
    index = []
    for dim, entry in zip(a.shape, spec):
        if entry is None:
            index.append(slice(None))
            continue
        axes = (entry,) if isinstance(entry, str) else entry
        n = int(np.prod([sizes[x] for x in axes]))
        i = int(np.ravel_multi_index([coords[x] for x in axes],
                                     [sizes[x] for x in axes]))
        index.append(slice(i * (dim // n), (i + 1) * (dim // n)))
    return a[tuple(index)]


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_shard_tree_cuts_like_numpy(spec):
    rng = np.random.default_rng(0)
    mesh = NamedMesh(["cpu"] * 12, ("pod", "data", "model"), (2, 3, 2))
    a = rng.standard_normal((12, 24)).astype(np.float32)
    b = rng.integers(0, 100, (12, 24)).astype(np.int32)
    tree = {"a": torch.from_numpy(a), "nested": [torch.from_numpy(b)]}
    out = shard_tree(mesh, tree, {"a": spec, "nested": [spec]})
    for arr, blocks in ((a, out["a"]), (b, out["nested"][0])):
        assert len(blocks) == mesh.n_shards
        for s, blk in enumerate(blocks):
            want = _numpy_block(arr, spec, mesh.coords(s), SIZES)
            assert np.array_equal(blk.numpy(), want)
            assert blk.numel() == shard_numel(arr.shape, spec, SIZES)
    # fresh copies: writing one block leaves the source alone
    out["a"][0].fill_(7.0)
    assert np.array_equal(tree["a"].numpy(), a)


def test_named_mesh_is_row_major_and_flat():
    mesh = NamedMesh(["cpu"] * 6, ("data", "model"), (3, 2))
    assert [tuple(mesh.coords(s).values()) for s in range(6)] == \
        [(0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (2, 1)]
    assert mesh.shape == {"data": 3, "model": 2}
    assert isinstance(mesh, Mesh) and mesh.n_shards == 6
    # the flat collectives are the Mesh's
    xs = [torch.full((2,), float(s)) for s in range(6)]
    assert torch.equal(mesh.psum(xs)[3], torch.full((2,), 15.0))
    with pytest.raises(ValueError):
        NamedMesh(["cpu"] * 5, ("data", "model"), (3, 2))
    with pytest.raises(ValueError):
        shard_tree(mesh, {"x": torch.zeros(4, 5)}, {"x": P("data", None)})


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_needs_no_device(multi_pod, monkeypatch):
    # no CUDA device, whatever the host has: the mesh is shapes over meta
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    mesh = make_production_mesh(multi_pod=multi_pod)
    want = {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}
    assert mesh.shape == want
    assert mesh.n_shards == int(np.prod(list(want.values())))
    assert {d.type for d in mesh.devices} == {"meta"}
    assert dp_axes(mesh) == dp_axes_of(mesh) == tuple(a for a in want if a != "model")
    blocks = shard_tree(mesh, {"w": torch.empty(64, 32, device="meta")},
                        {"w": P(dp_axes(mesh), "model")})["w"]
    assert len(blocks) == mesh.n_shards
    assert tuple(blocks[0].shape) == (64 // (mesh.n_shards // 16), 2)


def test_local_mesh_and_named():
    mesh = local_mesh(4, device="cpu")
    assert mesh.shape == {"data": 4, "model": 1}
    assert dp_axes_of(mesh) == ("data",)
    assert dp_axes_of(NamedMesh(["cpu"], ("model",), (1,))) == ("model",)
    ns = named(mesh, P("data"))
    assert ns.mesh is mesh and ns.spec == P("data")
    assert repr(P("data", None)) == "P('data', None)"
