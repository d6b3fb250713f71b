"""The sharded general lane's attach behind the kernel seam
(``kernels.ops.sharded_attach``), on the CPU.

On the CPU the seam takes the plain version (``ref.sharded_attach_ref``,
the per-landmark loop).  The CUDA kernels cannot run here, so a PyTorch
model of them (``helpers.sharded_attach_cases.MODEL``: int32 words, the act
bitmaps, the in-edge segments, the gathered tables, the flag) stands in at
the seam and drives ``general_lane`` on meshes of 1, 2 and 4 CPU shards,
held to the plain version bit for bit at 2B widths that cross a 32-row
word (B = 1, 17, 35), with the closure cut at one step and left to run.
Then the in-edge CSR, the word-table exchange and its bytes, the kernel
path's counters, and the argument checks.  Every comparison is exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import sharded_attach_cases as cases  # noqa: E402

from repro_torch import trace  # noqa: E402
from repro_torch.core.distributed import Halo  # noqa: E402
from repro_torch.core.mesh import Mesh  # noqa: E402
from repro_torch.kernels import LAUNCHES, ops  # noqa: E402
from repro_torch.kernels import attach_sharded as sa  # noqa: E402

_INDEX = {}


def _index(n_shards, max_chain):
    key = (n_shards, max_chain)
    if key not in _INDEX:
        _INDEX[key] = cases.index(n_shards, max_chain)
    return _INDEX[key]


@pytest.mark.parametrize("max_chain", [1, 16])
@pytest.mark.parametrize("b", [1, 17, 35])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_model_matches_plain_through_the_lane(n_shards, b, max_chain):
    idx = _index(n_shards, max_chain)
    us, vs = cases.pairs(idx, b, seed=b)
    want_d, want_m = idx.serve_step(us, vs)
    count = LAUNCHES["sharded_attach"]
    with cases.both_paths(cases.MODEL) as rec:
        got_d, got_m = idx.serve_step(us, vs)
    assert LAUNCHES["sharded_attach"] == count        # neither is a kernel
    (plain,), (model,), (steps,) = rec.plain, rec.kernel, rec.steps
    assert len(plain) == len(model) == n_shards
    for p, m in zip(plain, model):
        assert p.shape == m.shape == (b, idx.part.e_max)
        assert torch.equal(p, m)
    assert 1 <= steps <= max_chain
    assert torch.equal(got_d, want_d) and torch.equal(got_m, want_m)


def test_closure_cut_matters():
    """At B = 35 on two shards the closure takes more than one step, so
    ``max_chain`` 1 cuts chains that 16 lets grow, in both paths alike."""
    out = {}
    for mc in (1, 16):
        idx = _index(2, mc)
        us, vs = cases.pairs(idx, 35, seed=35)
        with cases.both_paths(cases.MODEL) as rec:
            idx.serve_step(us, vs)
        out[mc] = rec.kernel[0], rec.steps[0]
    assert out[16][1] > 1
    assert any(not torch.equal(a, c) for a, c in zip(out[1][0], out[16][0]))


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_in_edge_csr_covers_each_valid_slot_once(n_shards):
    idx = _index(n_shards, 16)
    plan = idx.record.attach_plan
    v_loc = plan.v_loc
    for s in range(n_shards):
        dst = plan.dst[s].to(torch.int64)
        indptr = plan.indptr[s].to(torch.int64)
        assert indptr.shape == (v_loc + 1,) and int(indptr[0]) == 0
        n_valid = int((dst < v_loc).sum())
        assert int(indptr[-1]) == n_valid
        for y in range(v_loc):
            assert bool((dst[indptr[y]:indptr[y + 1]] == y).all())
        seen = torch.zeros(dst.shape[0], dtype=torch.int64)
        for y, beg in zip(plan.seg_row[s].tolist(), plan.seg_beg[s].tolist()):
            end = min(beg + 32, int(indptr[y + 1]))
            assert beg < end
            seen[beg:end] += 1
        assert bool((seen[:n_valid] == 1).all()) and not bool(seen[n_valid:].any())
        assert bool((dst[n_valid:] == v_loc).all())        # pads, never pulled
        lms = idx.labels.landmarks[s].to(torch.int64)
        assert torch.equal(plan.lid[s][lms], torch.arange(lms.shape[0], dtype=torch.int32))
        assert int((plan.lid[s] >= 0).sum()) == lms.shape[0]


@pytest.mark.parametrize("n_shards", [2, 4])
def test_word_exchange_counts_its_bytes(n_shards):
    mesh = Mesh(["cpu"] * n_shards)
    idx = _index(n_shards, 16)
    halo = Halo(mesh, idx.record.src_sh, idx.labels.vstart, idx.labels.v_loc)
    rng = np.random.default_rng(n_shards)
    tables = [torch.as_tensor(rng.integers(-2**31, 2**31, (64, 2, 6)), dtype=torch.int32)
              for _ in range(n_shards)]
    acts = [torch.as_tensor(rng.integers(-2**31, 2**31, (2,)), dtype=torch.int32)
            for _ in range(n_shards)]
    trace.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got_t, got_a = halo.words(tables, acts)
    for g_t, g_a in zip(got_t, got_a):
        assert torch.equal(g_t, torch.stack(tables)) and torch.equal(g_a, torch.stack(acts))
    assert got_t[0] is not got_t[-1] and got_t[0].data_ptr() != tables[0].data_ptr()
    (rec,) = trace.report()["records"]
    assert rec["name"] == "sharded.halo"
    assert rec["counts"] == {"sharded.halo_bytes": n_shards * (n_shards - 1)
                             * (64 * 2 * 6 * 4 + 2 * 4)}


def test_kernel_path_counts_steps_syncs_and_exchanges(monkeypatch):
    """Under a profiler the model-driven path counts its closure steps
    (``sharded.closure_steps``) and one host wait per step inside the
    attach span; its exchanges there are word-table all-gathers, one after
    the certificate and one after each step that moved, each ``S (S - 1)``
    times the table's and act's bytes.  The plain path counts no step."""
    n = 4
    idx = _index(n, 16)
    us, vs = cases.pairs(idx, 17, seed=4)
    monkeypatch.setattr(ops, "sharded_attach", lambda mesh, halo, plan, inp, mc:
                        sa.drive(mesh, halo, plan, inp, mc, cases.MODEL))
    trace.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        idx.serve_step(us, vs)
    r = trace.report()
    recs = {x["id"]: x for x in r["records"]}
    (attach,) = [x for x in recs.values() if x["name"] == "sharded.attach"]
    steps = r["counters"]["sharded.closure_steps"]
    assert 1 <= steps <= 16
    assert attach["counts"] == {"sharded.closure_steps": steps,
                                "sharded.host_syncs": steps}
    halos = [x for x in recs.values() if x["parent"] == attach["id"]]
    assert {x["name"] for x in halos} == {"sharded.halo"}
    assert steps <= len(halos) <= steps + 1
    wloc = (idx.labels.v_loc + 31) // 32
    words = 32 * wloc * 2 * idx.labels.n_landmarks + wloc    # 2B = 34 rows: W = 2
    assert {x["counts"]["sharded.halo_bytes"] for x in halos} == {n * (n - 1) * words * 4}
    monkeypatch.undo()
    trace.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        idx.serve_step(us, vs)
    assert "sharded.closure_steps" not in trace.report()["counters"]


def _captured():
    """``(mesh, halo, plan, inp)`` of one lane call on two CPU shards."""
    idx = _index(2, 16)
    us, vs = cases.pairs(idx, 5)
    got = []
    seam = ops.sharded_attach

    def keep(*a):
        got.append(a[:4])
        return seam(*a)
    ops.sharded_attach = keep
    try:
        idx.serve_step(us, vs)
    finally:
        ops.sharded_attach = seam
    return got[0]


def _swap(name, mesh, halo, plan, inp):
    """``(plan, inp, max_chain)`` with one argument of shard 0 broken."""
    def inp_with(field, t):
        return inp._replace(**{field: [t] + list(getattr(inp, field)[1:])})

    def plan_with(field, t):
        return plan._replace(**{field: [t] + list(getattr(plan, field)[1:])})
    sides, sigma = inp.sides[0], inp.sigma[0]
    return {
        "sides int64": (plan, inp_with("sides", sides.long()), 4),
        "sides odd rows": (plan, inp_with("sides", sides[:-1]), 4),
        "sides width": (plan, inp_with("sides", sides[:, :-1]), 4),
        "sigma rows": (plan, inp_with("sigma", sigma[:-2]), 4),
        "sigma int64": (plan, inp_with("sigma", sigma.long()), 4),
        "labels shape": (plan, inp_with("labels", inp.labels[0][:-1]), 4),
        "label_src int64": (plan, inp_with("label_src", inp.label_src[0].long()), 4),
        "label_src width": (plan, inp_with("label_src", inp.label_src[0][:, :-1]), 4),
        "src length": (plan_with("src", plan.src[0][:-1]), inp, 4),
        "indptr length": (plan_with("indptr", plan.indptr[0][:-1]), inp, 4),
        "lid int64": (plan_with("lid", plan.lid[0].long()), inp, 4),
        "vstart length": (plan_with("vstart", plan.vstart[0][:1]), inp, 4),
        "max_chain": (plan, inp, -1),
    }[name]


BAD = ["sides int64", "sides odd rows", "sides width", "sigma rows", "sigma int64",
       "labels shape", "label_src int64", "label_src width", "src length",
       "indptr length", "lid int64", "vstart length", "max_chain"]


@pytest.mark.parametrize("name", BAD)
def test_check_sharded_attach_args_raises(name):
    mesh, halo, plan, inp = _captured()
    bad_plan, bad_inp, mc = _swap(name, mesh, halo, plan, inp)
    with pytest.raises(ValueError):
        sa.check_sharded_attach_args(bad_plan, bad_inp, mc)
    with pytest.raises(ValueError):
        ops.sharded_attach(mesh, halo, bad_plan, bad_inp, mc)
    sa.check_sharded_attach_args(plan, inp, 4)                 # the good ones pass


def test_wrapper_refuses_host_and_strided_tensors():
    """The CUDA wrapper takes each shard's tensors contiguous and on one
    CUDA device: host tensors, or a strided view, raise before any build."""
    mesh, halo, plan, inp = _captured()
    with pytest.raises(ValueError, match="CUDA device"):
        sa.sharded_attach_cuda(mesh, halo, plan, inp, 4)
    strided = inp.sides[0].T.contiguous().T
    assert not strided.is_contiguous()
    bad = inp._replace(sides=[strided] + list(inp.sides[1:]))
    with pytest.raises(ValueError, match="contiguous"):
        sa.sharded_attach_cuda(mesh, halo, plan, bad, 4)


def test_plan_refuses_unsorted_destinations():
    idx = _index(2, 16)
    dst = idx.record.dst_sh[0].flip(0).contiguous()
    with pytest.raises(ValueError, match="sorted"):
        sa.make_attach_plan([idx.record.src_sh[0]], [dst], idx.labels.vstart[:1],
                            idx.labels.v_loc, idx.labels.landmarks[:1],
                            idx.labels.n_vertices)
