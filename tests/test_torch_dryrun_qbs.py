"""The dry run's QbS collective model against the port's own sharded steps:
one level of the edge-sharded labelling (``bool``, ``bitmap`` and ``pull``
exchanges) and one level of ``scale_serve``'s sketch-bounded Bi-BFS, run
for real on ``Mesh(["cpu"] * 4)`` over a 300-vertex graph, move exactly the
collectives (kind and bytes, in order) that
``dryrun.labelling_level_calls`` and ``dryrun.scale_serve_level_calls``
predict from the shapes.  The bytes are counted by wrapping
``core.mesh.Mesh``'s collectives: each call's output on one shard (what
the reference's HLO parser counts per device), with ``replicate`` counted
as ``broadcast``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import distributed as td  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core.labelling import build_labelling  # noqa: E402
from repro_torch.core.mesh import Mesh  # noqa: E402
from repro_torch.core.scale_serve import scale_serve  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402

N_SHARDS, R = 4, 6
KINDS = {"all_gather": "all-gather", "all_to_all": "all-to-all", "psum": "all-reduce",
         "pmin": "all-reduce", "pmax": "all-reduce", "psum_scatter": "reduce-scatter",
         "replicate": "broadcast"}


@pytest.fixture
def calls(monkeypatch):
    log: list = []
    for meth, kind in KINDS.items():
        orig = getattr(Mesh, meth)

        def wrapped(self, xs, _orig=orig, _kind=kind):
            out = _orig(self, xs)
            log.append((_kind, out[0].numel() * out[0].element_size()))
            return out

        monkeypatch.setattr(Mesh, meth, wrapped)
    return log


@pytest.fixture(scope="module")
def graph():
    g = tg.barabasi_albert_graph(300, 3, seed=0, device="cpu")
    return g, np.asarray(tg.select_landmarks(g, R))


@pytest.mark.parametrize("mode", ["bool", "bitmap", "pull"])
def test_labelling_level_collectives(graph, calls, mode):
    g, lms = graph
    mesh = Mesh(["cpu"] * N_SHARDS)
    part = td.partition_edges(g, N_SHARDS)
    src, dst = mesh.shard(part.src), mesh.shard(part.dst_local)
    lm = [torch.as_tensor(lms.astype(np.int32)) for _ in range(N_SHARDS)]
    p_pad = 0
    if mode == "pull":
        plan = td.build_pull_plan(part, N_SHARDS)
        p_pad = plan.p_pad
        step = td.make_labelling_step_pull(
            mesh, n_vertices=g.n_vertices, v_loc=part.v_loc, p_pad=p_pad, n_landmarks=R)
        plan_sh = [mesh.shard(plan.send_idx), mesh.shard(plan.edge_word),
                   mesh.shard(plan.edge_bit)]
        calls.clear()
        step(src, dst, part.vstart, lm, *plan_sh)
    else:
        step = td.make_labelling_step(mesh, n_vertices=g.n_vertices, v_loc=part.v_loc,
                                      n_landmarks=R, frontier_mode=mode)
        calls.clear()
        step(src, dst, part.vstart, lm)
    level = D.labelling_level_calls(mode, N_SHARDS, R, part.v_loc, p_pad)
    n_levels = len(calls) // len(level)
    assert n_levels >= 3
    assert calls == level * n_levels


def test_scale_serve_level_collectives(graph, calls):
    g, lms = graph
    mesh = Mesh(["cpu"] * N_SHARDS)
    scheme = build_labelling(g, torch.as_tensor(lms), device="cpu")
    rng = np.random.default_rng(0)
    us = rng.integers(0, g.n_vertices, 8).astype(np.int32)
    vs = rng.integers(0, g.n_vertices, 8).astype(np.int32)
    b = us.shape[0]
    part = td.partition_edges(g, N_SHARDS)
    calls.clear()
    scale_serve(g, scheme, mesh, us, vs)
    # before the first level: the landmarks replicated, then phase A (each
    # endpoint's label row from its owner: the ids replicated, a pmin of
    # the (B, R) int32 rows) and each side's depth seeded (the ids again)
    prefix = [("broadcast", R * 4),
              ("broadcast", 4 * b), ("all-reduce", 4 * b * R),
              ("broadcast", 4 * b), ("all-reduce", 4 * b * R),
              ("broadcast", 4 * b), ("broadcast", 4 * b)]
    assert calls[:len(prefix)] == prefix
    level = D.scale_serve_level_calls(N_SHARDS, part.v_loc, b)
    rest = calls[len(prefix):]
    n_levels = 0
    while rest[:len(level)] == level:
        rest = rest[len(level):]
        n_levels += 1
    assert n_levels >= 2
