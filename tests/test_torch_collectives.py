"""Port vs reference: the compressed data-parallel collectives
(``repro_torch.distributed``) on the port's one-controller ``Mesh``.

On ``Mesh(["cpu"])`` each helper equals the reference's ``shard_map``
version on a one-device mesh, run as ``tests/test_substrate.py::
test_compressed_psum_shard_map`` runs it; on ``Mesh(["cpu"] * 4)`` each
equals a numpy transcription of the reference's formula (shards summed in
order, bf16 rounding after every add for ``psum_bf16``; the int8 path's
int32 sum times the mean of the shards' scales)."""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.compat import shard_map  # noqa: E402
from repro.distributed import all_gather_params as j_all_gather  # noqa: E402
from repro.distributed import psum_bf16 as j_psum_bf16  # noqa: E402
from repro.distributed import psum_int8_ef as j_psum_int8_ef  # noqa: E402
from repro.distributed import zero1_update as j_zero1  # noqa: E402
from repro_torch.core.mesh import Mesh  # noqa: E402
from repro_torch.distributed import (  # noqa: E402
    all_gather_params,
    psum_bf16,
    psum_int8_ef,
    zero1_update,
)


def _grads(seed, n_shards, shape=(64,)):
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(size=shape).astype(np.float32),
             "blk": {"b": (rng.normal(size=(3, 5)) * 1e-3).astype(np.float32)}}
            for _ in range(n_shards)]


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], f"{prefix}{k}/")]
    return [(prefix, tree)]


def _assert_trees_equal(got, want):
    for (kg, g), (kw, w) in zip(_leaves(got), _leaves(want), strict=True):
        assert kg == kw
        np.testing.assert_array_equal(_np(g), np.asarray(w), err_msg=kg)


def _one_device(body, out_like, *trees, in_spec=P(), out_spec=P()):
    """``body`` under ``shard_map`` on a one-device mesh; ``out_like`` has
    the structure of its output."""
    mesh = JMesh(np.array(jax.devices()[:1]), ("data",))
    specs = tuple(jax.tree_util.tree_map(lambda _: in_spec, t) for t in trees)
    out_specs = jax.tree_util.tree_map(lambda _: out_spec, out_like)
    return jax.jit(shard_map(body, mesh=mesh, in_specs=specs, out_specs=out_specs))(*trees)


def test_psum_bf16_one_device_equals_reference():
    g = _grads(0, 1)[0]
    want = _one_device(lambda t: j_psum_bf16(t, ("data",)), g, g)
    got = psum_bf16([_t(g)], Mesh(["cpu"]))
    assert len(got) == 1 and got[0]["w"].dtype == torch.float32
    _assert_trees_equal(got[0], want)
    np.testing.assert_allclose(got[0]["w"].numpy(), g["w"], rtol=1e-2, atol=1e-2)


def test_psum_int8_ef_one_device_equals_reference():
    g = _grads(1, 1)[0]
    e = jax.tree_util.tree_map(lambda x: (x * 0.01).astype(np.float32), _grads(2, 1)[0])
    want, want_err = _one_device(lambda t, s: j_psum_int8_ef(t, s, ("data",)),
                                 (g, e), g, e)
    got, err = psum_int8_ef([_t(g)], [_t(e)], Mesh(["cpu"]))
    _assert_trees_equal(got[0], want)
    # XLA contracts the residual g - q * scale into one fused multiply-add;
    # torch rounds the product first: within half an ulp of |q * scale|
    for (_, e_got), (_, e_want), (_, red) in zip(_leaves(err[0]), _leaves(want_err),
                                                 _leaves(want)):
        np.testing.assert_allclose(e_got.numpy(), np.asarray(e_want), rtol=0,
                                   atol=float(np.abs(np.asarray(red)).max()) * 2 ** -24)
    np.testing.assert_allclose(got[0]["w"].numpy(), g["w"] + e["w"], atol=0.05)
    assert float(err[0]["w"].abs().max()) <= 0.05


def test_zero1_and_all_gather_one_device_equal_reference():
    x = np.random.default_rng(3).normal(size=(32,)).astype(np.float32)
    want = _one_device(lambda v: j_zero1(v, "data"), x, x, out_spec=P("data"))
    got = zero1_update([torch.from_numpy(x.copy())], Mesh(["cpu"]))
    _assert_trees_equal(got[0], want)
    want = _one_device(lambda v: j_all_gather(v, "data"), x, x, in_spec=P("data"),
                      out_spec=P("data"))
    got = all_gather_params([torch.from_numpy(x.copy())], Mesh(["cpu"]))
    _assert_trees_equal(got[0], want)


# -- four shards, against numpy transcriptions of the reference's formulas --

def _psum_bf16_np(xs):
    acc = xs[0].astype(ml_dtypes.bfloat16)
    for x in xs[1:]:
        acc = (acc + x.astype(ml_dtypes.bfloat16)).astype(ml_dtypes.bfloat16)
    return acc.astype(np.float32)


def _int8_ef_np(gs, es):
    g32 = [g.astype(np.float32) + e for g, e in zip(gs, es)]
    scales = [np.float32(np.max(np.abs(g)) / np.float32(127.0) + np.float32(1e-12))
              for g in g32]
    qs = [np.round(g / s).astype(np.int8) for g, s in zip(g32, scales)]
    errs = [g - q.astype(np.float32) * s for g, q, s in zip(g32, qs, scales)]
    red = sum(q.astype(np.int32) for q in qs).astype(np.float32)
    ssum = scales[0]
    for s in scales[1:]:
        ssum = np.float32(ssum + s)
    return red * np.float32(ssum / np.float32(len(gs))), errs


def test_psum_bf16_four_shards():
    gs = _grads(4, 4)
    got = psum_bf16([_t(g) for g in gs], Mesh(["cpu"] * 4))
    for shard in got:
        np.testing.assert_array_equal(shard["w"].numpy(), _psum_bf16_np([g["w"] for g in gs]))
        np.testing.assert_array_equal(shard["blk"]["b"].numpy(),
                                      _psum_bf16_np([g["blk"]["b"] for g in gs]))
    got[0]["w"].add_(1)                       # every shard holds its own tensor
    assert not torch.equal(got[0]["w"], got[1]["w"])


def test_psum_int8_ef_four_shards_and_error_feedback():
    gs = _grads(5, 4)
    es = [jax.tree_util.tree_map(np.zeros_like, g) for g in gs]
    mesh = Mesh(["cpu"] * 4)
    t_es = [_t(e) for e in es]
    for step in range(3):
        got, t_es = psum_int8_ef([_t(g) for g in gs], t_es, mesh)
        for key in (("w",), ("blk", "b")):
            def leaf(tree):
                for k in key:
                    tree = tree[k]
                return tree
            want, errs = _int8_ef_np([leaf(g) for g in gs], [leaf(e) for e in es])
            for s in range(4):
                np.testing.assert_array_equal(leaf(got[s]).numpy(), want)
                np.testing.assert_array_equal(leaf(t_es[s]).numpy(), errs[s])
            for s in range(4):
                tgt = es[s]
                for k in key[:-1]:
                    tgt = tgt[k]
                tgt[key[-1]] = errs[s]
    # the residual each shard carries is below half its quantisation step
    for s, g in enumerate(gs):
        step_w = np.max(np.abs(g["w"] + es[s]["w"])) / 127
        assert np.abs(t_es[s]["w"].numpy()).max() <= step_w


def test_zero1_reduce_scatter_and_all_gather_four_shards():
    rng = np.random.default_rng(6)
    xs = [rng.normal(size=(32,)).astype(np.float32) for _ in range(4)]
    mesh = Mesh(["cpu"] * 4)
    got = zero1_update([torch.from_numpy(x) for x in xs], mesh)
    total = xs[0].copy()
    for x in xs[1:]:
        total = total + x
    for s in range(4):
        np.testing.assert_array_equal(got[s].numpy(), total.reshape(4, 8)[s])
    gathered = all_gather_params(got, mesh)
    for s in range(4):
        np.testing.assert_array_equal(gathered[s].numpy(), total)
    with pytest.raises(ValueError, match="split"):
        zero1_update([torch.zeros(6)] * 4, mesh)
    two = all_gather_params([torch.ones(2, 3), torch.zeros(2, 3)], Mesh(["cpu"] * 2))
    assert two[1].shape == (4, 3) and float(two[1][:2].sum()) == 6.0


def test_psum_int8_ef_mean_of_scales_is_a_reference_fault():
    """The reference's int8 reduce multiplies the int32 sum of the shards'
    int8 values by the *mean* of their scales, which is the sum only when
    the scales agree.  Shard 0 holds [1, 0.5] (scale 1/127), shard 1
    [100, 0] (scale 100/127): the second element comes back as 25.4, not
    0.5, far outside the quantisation error, and error feedback never sees
    it (each shard's residual is taken against its own scale).  The port
    keeps the reference's formula; this pins it."""
    gs = [{"w": np.array([1.0, 0.5], np.float32)}, {"w": np.array([100.0, 0.0], np.float32)}]
    es = [{"w": np.zeros(2, np.float32)} for _ in gs]
    got, errs = psum_int8_ef([_t(g) for g in gs], [_t(e) for e in es], Mesh(["cpu"] * 2))
    want, _ = _int8_ef_np([g["w"] for g in gs], [e["w"] for e in es])
    np.testing.assert_array_equal(got[0]["w"].numpy(), want)
    exact = gs[0]["w"] + gs[1]["w"]
    assert abs(float(got[0]["w"][1]) - exact[1]) > 20.0          # 25.45 vs 0.5
    assert max(float(e["w"].abs().max()) for e in errs) < 0.5     # feedback is blind to it
