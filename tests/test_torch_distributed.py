"""Port vs reference: the mesh and its collectives, the edge partition, the
edge-sharded labelling (``bool``, ``bitmap`` and ``pull`` exchanges) and the
born-sharded packed tables (``repro_torch.core.mesh`` and
``repro_torch.core.distributed``).

The port's mesh is a list of devices, here ``Mesh(["cpu"] * S)`` for
S in {1, 2, 3, 4, 8}.  At S = 1 the port is held against the reference's
own distributed functions on a one-device JAX mesh (the reference's
multi-device runs need a forced device count, fixed at JAX's first
initialisation); for every S it is held against the single-device
labelling and ``pack_labelling`` of both packages.  Every comparison is
exact, with zero tolerance: distances and packed entries are integers,
flags booleans.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

from repro.core import graph as jg  # noqa: E402
from repro.core import distributed as jd  # noqa: E402
from repro.core.labelling import build_labelling as j_build_labelling  # noqa: E402
from repro.core.packing import pack_labelling as j_pack_labelling  # noqa: E402
from repro.core.qbs import _dists_to_landmark_batch as j_lm_dist  # noqa: E402
from repro_torch.core import distributed as td  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core.labelling import build_labelling as t_build_labelling  # noqa: E402
from repro_torch.core.mesh import Mesh, resolve_mesh  # noqa: E402
from repro_torch.core.packing import pack_labelling as t_pack_labelling  # noqa: E402
from repro_torch.core.qbs import _dists_to_landmark_batch as t_lm_dist  # noqa: E402

PATH_EDGES = np.stack([np.arange(299), np.arange(1, 300)], axis=1)

GRAPHS = {
    "gnp": (lambda m, **kw: m.gnp_random_graph(60, 3.5, seed=42, **kw), 5, 64),
    "grid": (lambda m, **kw: m.grid_graph(7, 7, **kw), 4, 64),
    "ba": (lambda m, **kw: m.barabasi_albert_graph(1000, 3, seed=0, **kw), 10, 64),
    # labels past 255: the tables pack to uint16
    "path": (lambda m, **kw: m.from_edges(PATH_EDGES, 300, **kw), 2, 400),
}
SHARDS = [1, 2, 3, 4, 8]
MODES = ["bool", "bitmap", "pull"]
SCHEME_FIELDS = ("landmarks", "lid", "is_landmark", "label_dist", "meta_w",
                 "meta_dist")


def _graphs(name):
    gen, nl, levels = GRAPHS[name]
    gj, gt = gen(jg), gen(tg, device="cpu")
    lms = jg.select_landmarks(gj, nl)
    assert np.array_equal(lms, tg.select_landmarks(gt, nl))
    return gj, gt, lms, levels


def _jmesh():
    return JMesh(np.array(jax.devices()[:1]), ("shards",))


@pytest.fixture(scope="module")
def single():
    """Per graph: the single-device labelling of both packages and the
    reference's packed tables (with the (R, V) landmark-distance table)."""
    out = {}
    for name in GRAPHS:
        gj, gt, lms, levels = _graphs(name)
        sj = j_build_labelling(gj, lms, max_levels=levels)
        st = t_build_labelling(gt, lms, max_levels=levels, device="cpu")
        for f in SCHEME_FIELDS:
            assert np.array_equal(np.asarray(getattr(sj, f)), getattr(st, f).numpy())
        lm = j_lm_dist(sj.label_dist, sj.meta_dist, sj.lid, sj.is_landmark,
                       np.arange(len(lms)))
        out[name] = (gj, gt, lms, levels, st, j_pack_labelling(sj, lm_dist=lm))
    return out


# -- the mesh ----------------------------------------------------------------


def _per_shard(s, dtype=torch.int32):
    rng = np.random.default_rng(s)
    return [torch.as_tensor(rng.integers(0, 50, size=(s, 3, 5))).to(dtype)
            for _ in range(s)]


COLLECTIVES = {
    "all_gather": lambda m, xs: m.all_gather(xs),
    "all_to_all": lambda m, xs: m.all_to_all(xs),
    "psum": lambda m, xs: m.psum(xs),
    "pmin": lambda m, xs: m.pmin(xs),
    "pmax": lambda m, xs: m.pmax(xs),
    "replicate": lambda m, xs: m.replicate(xs[0]),
}


def _want(op, xs):
    full = torch.stack(xs)
    if op == "all_gather":
        return [full] * len(xs)
    if op == "all_to_all":
        return [full[:, j] for j in range(len(xs))]
    if op == "replicate":
        return [xs[0]] * len(xs)
    red = {"psum": full.sum(0), "pmin": full.amin(0), "pmax": full.amax(0)}[op]
    return [red.to(xs[0].dtype)] * len(xs)


@pytest.mark.parametrize("s", [1, 2, 3])
@pytest.mark.parametrize("op", sorted(COLLECTIVES))
def test_collectives_return_fresh_tensors(op, s):
    """Every output is a new tensor: writing into one shard's result
    reaches neither the inputs nor another shard's result (``t.to(d)``
    returns ``t`` itself on its own device)."""
    mesh = Mesh(["cpu"] * s)
    xs = _per_shard(s)
    before = [x.clone() for x in xs]
    out = COLLECTIVES[op](mesh, xs)
    want = _want(op, before)
    assert len(out) == s
    for o, w in zip(out, want):
        assert torch.equal(o, w)
    for k, o in enumerate(out):
        o.fill_(-7)
        assert all(torch.equal(x, b) for x, b in zip(xs, before)), op
        for j, other in enumerate(out):
            if j != k:
                assert not torch.equal(other, torch.full_like(other, -7)), op
        o.copy_(want[k])


def test_uint16_travels_bit_exact():
    mesh = Mesh(["cpu"] * 3)
    xs = [torch.as_tensor(np.full((2, 4), 65535 - k, np.uint16)) for k in range(3)]
    for out in (mesh.all_gather(xs), mesh.replicate(xs[1])):
        for o in out:
            assert o.dtype == torch.uint16
    got = _np(mesh.all_gather(xs)[2])
    assert np.array_equal(got, np.stack([np.full((2, 4), 65535 - k) for k in range(3)]))


def test_resolve_mesh(monkeypatch):
    mesh = Mesh(["cpu"] * 2)
    assert resolve_mesh(mesh) is mesh and mesh.n_shards == 2
    with pytest.raises(ValueError):
        Mesh([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for n in (None, 1, 4):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_mesh(n)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    got = resolve_mesh(2)
    assert got.devices == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert resolve_mesh(None).n_shards == 2
    for n in (3, 8, 0):
        with pytest.raises(ValueError, match="devices requested"):
            resolve_mesh(n)


# -- the edge partition ------------------------------------------------------


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("name", ["gnp", "grid", "ba"])
def test_partition_edges_matches_reference(name, s):
    gj, gt, _, _ = _graphs(name)
    want = jd.partition_edges(gj, s)
    got = td.partition_edges(gt, s)
    assert (got.v_loc, got.e_max) == (want.v_loc, want.e_max)
    for f in ("src", "dst_local", "vstart", "eid"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    plan, jplan = td.build_pull_plan(got, s), jd.build_pull_plan(want, s)
    assert plan.p_pad == jplan.p_pad
    for f in ("send_idx", "edge_word", "edge_bit"):
        assert np.array_equal(getattr(plan, f), getattr(jplan, f)), f


# -- the edge-sharded labelling ---------------------------------------------


def _same_scheme(got, want_fields):
    for f in SCHEME_FIELDS:
        a = getattr(got, f)
        assert a.device == torch.device("cpu")
        assert np.array_equal(a.numpy(), np.asarray(getattr(want_fields, f))), f


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["gnp", "grid"])
def test_labelling_one_shard_matches_reference(name, mode):
    gj, gt, lms, _ = _graphs(name)
    want = jd.distributed_build_labelling(gj, lms, _jmesh(), frontier_mode=mode)
    got = td.distributed_build_labelling(gt, lms, Mesh(["cpu"]),
                                         frontier_mode=mode)
    _same_scheme(got, want)


@pytest.mark.parametrize("s", SHARDS[1:])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_labelling_matches_single_device(single, name, mode, s):
    _, gt, lms, levels, st, _ = single[name]
    got = td.distributed_build_labelling(gt, lms, Mesh(["cpu"] * s),
                                         frontier_mode=mode, max_levels=levels)
    _same_scheme(got, st)
    assert got.label_dist.dtype == torch.int32 and got.label_dist.is_contiguous()


def test_labelling_rejects_an_unknown_mode():
    _, gt, lms, _ = _graphs("gnp")
    with pytest.raises(ValueError, match="frontier_mode"):
        td.distributed_build_labelling(gt, lms, Mesh(["cpu"] * 2),
                                       frontier_mode="gossip")


# -- the born-sharded build --------------------------------------------------


def _np(t):
    """A (possibly uint16) CPU tensor as numpy, through the int16 view."""
    return t.view(torch.int16).numpy().view(np.uint16) \
        if t.dtype == torch.uint16 else t.numpy()


def _reassemble(sl, v):
    """The sharded blocks as full tables; every pad row / column must hold
    the sentinel."""
    r = sl.n_landmarks
    labels = np.zeros((v, r), sl.pack_dtype)
    lm = np.zeros((r, v), sl.pack_dtype)
    for s, (lab, lmb) in enumerate(zip(sl.labels_sh, sl.lm_sh)):
        a, n = int(sl.vstart[s]), int(sl.nloc[s])
        lab, lmb = _np(lab), _np(lmb)
        assert lab.shape == (sl.v_loc, r) and lmb.shape == (r, sl.v_loc)
        labels[a:a + n] = lab[:n]
        lm[:, a:a + n] = lmb[:, :n]
        assert (lab[n:] == sl.sentinel).all() and (lmb[:, n:] == sl.sentinel).all()
    return labels, lm


def _same_packed(sl, v, want):
    """``want``: (label_dist (V, R), meta_w, meta_dist, lm_dist (R, V))."""
    labels, lm = _reassemble(sl, v)
    assert sl.pack_dtype == np.asarray(want[0]).dtype
    assert np.array_equal(labels, np.asarray(want[0]))
    assert np.array_equal(lm, np.asarray(want[3]))
    for k, f in ((1, "meta_w"), (2, "meta_dist")):
        for copy in getattr(sl, f):           # one replicated copy per shard
            assert np.array_equal(_np(copy), np.asarray(want[k])), f


@pytest.mark.parametrize("name", ["gnp", "grid", "path"])
def test_sharded_build_one_shard_matches_reference(single, name):
    gj, gt, lms, levels, _, jpacked = single[name]
    want, jpart = jd.distributed_build_sharded(gj, lms, _jmesh(),
                                               max_levels=levels)
    got, part = td.distributed_build_sharded(gt, lms, Mesh(["cpu"]),
                                             max_levels=levels)
    assert got.pack_dtype == want.pack_dtype and got.v_loc == want.v_loc
    assert np.array_equal(got.vstart, want.vstart)
    assert np.array_equal(got.nloc, want.nloc)
    assert np.array_equal(_np(got.labels_sh[0]), np.asarray(want.labels_sh)[0])
    assert np.array_equal(_np(got.lm_sh[0]), np.asarray(want.lm_sh)[0])
    assert np.array_equal(_np(got.meta_w[0]), np.asarray(want.meta_w))
    assert np.array_equal(_np(got.meta_dist[0]), np.asarray(want.meta_dist))
    assert np.array_equal(part.eid, jpart.eid)
    _same_packed(got, gt.n_vertices, jpacked)
    assert got.per_device_label_bytes() == want.per_device_label_bytes()


@pytest.mark.parametrize("s", SHARDS[1:])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_sharded_build_matches_pack_labelling(single, name, s):
    _, gt, lms, levels, st, jpacked = single[name]
    got, part = td.distributed_build_sharded(gt, lms, Mesh(["cpu"] * s),
                                             max_levels=levels)
    assert len(got.labels_sh) == s and part.src.shape[0] == s
    _same_packed(got, gt.n_vertices, jpacked)
    # and the port's own single-device packing, in the same dtype
    lm = t_lm_dist(st.label_dist, st.meta_dist, st.lid, st.is_landmark,
                   torch.arange(len(lms)))
    tp = t_pack_labelling(st, lm_dist=lm)
    assert tp.dtype == got.pack_dtype
    _same_packed(got, gt.n_vertices, [_np(t) for t in
                                      (tp.label_dist, tp.meta_w, tp.meta_dist,
                                       tp.lm_dist)])
    assert [int(t.numel()) for t in got.landmarks] == [len(lms)] * s


@pytest.mark.parametrize("mode", MODES)
def test_sharded_build_every_exchange_mode(single, mode):
    """The born-sharded build runs the labelling in any exchange mode and
    packs the same blocks."""
    _, gt, lms, levels, _, jpacked = single["ba"]
    got, _ = td.distributed_build_sharded(gt, lms, Mesh(["cpu"] * 3),
                                          frontier_mode=mode, max_levels=levels)
    _same_packed(got, gt.n_vertices, jpacked)
