"""Port vs reference: the kernels' plain versions and the dispatch seam.

On this CPU the port's wrappers take each kernel's plain PyTorch version;
here it is held against the reference's Pallas kernel run in interpret
mode (as ``tests/test_kernels.py`` runs it) and against the reference's
``kernels/ref.py``.  Every comparison is exact, with zero tolerance: the
min-plus product is integer and the frontier expansion boolean.

The CUDA kernels themselves are compiled and run only on the card:
``tests/test_torch_kernels_cuda.py`` holds them against their plain
versions there.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core.graph import INF
from repro.core.packing import pack_bits as j_pack_bits
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.kernels.frontier import bitmap_expand as j_expand
from repro.kernels.frontier import bitmap_expand_packed as j_expand_packed
from repro.kernels.minplus import minplus as j_minplus
from repro_torch.core.packing import pack_bits
from repro_torch.kernels import LAUNCHES, ops, ref
from repro_torch.kernels.frontier import (
    bitmap_expand_cuda,
    bitmap_expand_packed_cuda,
    block_shape,
    dense_vector_loads,
    hybrid_relay_cuda,
)
from repro_torch.kernels.minplus import minplus_cuda


def _rand_dist(rng, shape):
    x = rng.integers(0, 64, size=shape)
    return np.where(rng.random(shape) < 0.2, INF, x).astype(np.int32)


MINPLUS_SHAPES = [(1, 1, 1), (8, 20, 20), (32, 20, 20), (128, 128, 128),
                  (130, 20, 50), (256, 64, 129), (5, 200, 7)]


@pytest.mark.parametrize("m,k,n", MINPLUS_SHAPES)
def test_minplus_plain_matches_pallas_interpret(m, k, n):
    rng = np.random.default_rng(m * 1000 + k * 10 + n)
    a, b = _rand_dist(rng, (m, k)), _rand_dist(rng, (k, n))
    want = np.asarray(j_minplus(jnp.asarray(a), jnp.asarray(b), interpret=True))
    got = ops.minplus(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(ref.minplus_ref(torch.from_numpy(a),
                                          torch.from_numpy(b)).numpy(),
                          np.asarray(j_ref.minplus_ref(a, b)))


def test_minplus_inf_saturation():
    a = torch.full((4, 4), INF, dtype=torch.int32)
    got = ops.minplus(a, a)
    assert (got >= 2 * INF).all()
    want = np.asarray(j_minplus(jnp.asarray(a.numpy()), jnp.asarray(a.numpy()),
                                interpret=True))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16])
def test_minplus_refuses_unsigned(dtype):
    a = torch.zeros((3, 4), dtype=dtype)
    b = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="widen"):
        ops.minplus(a, b)
    with pytest.raises(ValueError, match="widen"):
        ops.minplus(torch.zeros((3, 4), dtype=torch.int32),
                    torch.zeros((4, 2), dtype=dtype))
    with pytest.raises(ValueError):
        ops.minplus(torch.zeros((3, 4), dtype=torch.int32),
                    torch.zeros((5, 2), dtype=torch.int32))


def test_sketch_d_top_matches_reference():
    rng = np.random.default_rng(7)
    lu, lv = _rand_dist(rng, (32, 20)), _rand_dist(rng, (32, 20))
    md = _rand_dist(rng, (20, 20))
    want = np.asarray(j_ops.sketch_d_top(jnp.asarray(lu), jnp.asarray(lv),
                                         jnp.asarray(md), use_pallas=False))
    got = ops.sketch_d_top(torch.from_numpy(lu), torch.from_numpy(lv),
                           torch.from_numpy(md))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,v,w,density", [(17, 70, 90, 0.1), (40, 128, 128, 0.05),
                                           (8, 16, 16, 0.3), (3, 40, 100, 0.5)])
def test_bitmap_expand_packed_plain_matches_pallas_interpret(k, v, w, density):
    rng = np.random.default_rng(k * 100 + v)
    f = rng.random((k, v)) < 0.3
    adj = rng.random((v, w)) < density
    want = np.asarray(j_expand_packed(jnp.asarray(f), j_pack_bits(jnp.asarray(adj)),
                                      n_cols=w, interpret=True))
    words = pack_bits(torch.from_numpy(adj))
    got = ops.bitmap_expand_packed(torch.from_numpy(f), words, n_cols=w)
    assert got.dtype == torch.bool and got.shape == (k, w)
    assert np.array_equal(got.numpy(), want)
    dense = (f.astype(np.float32) @ adj.astype(np.float32)) > 0.5
    assert np.array_equal(got.numpy(), dense)


def _sym_adjacency(rng, v, density):
    adj = np.triu(rng.random((v, v)) < density, 1)
    return adj | adj.T


@pytest.mark.parametrize("r,v", [(1, 1), (8, 128), (20, 100), (20, 257),
                                 (3, 300), (64, 512)])
def test_bitmap_expand_plain_matches_pallas_interpret(r, v):
    """The reference's shapes and inputs (``tests/test_kernels.py``)."""
    rng = np.random.default_rng(r * 100 + v)
    f = rng.random((r, v)) < 0.1
    adj = _sym_adjacency(rng, v, 0.05)
    want = np.asarray(j_expand(jnp.asarray(f), jnp.asarray(adj), interpret=True))
    got = ops.bitmap_expand(torch.from_numpy(f), torch.from_numpy(adj))
    assert got.dtype == torch.bool and got.shape == (r, v)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(ref.bitmap_expand_ref(torch.from_numpy(f),
                                                torch.from_numpy(adj)).numpy(),
                          np.asarray(j_ref.bitmap_expand_ref(f, adj)))


@pytest.mark.parametrize("tk", [128, 256])
def test_bitmap_expand_k_grid_accumulation(tk):
    """The reference accumulates over a K grid of ``tk``-wide steps; the
    port's answer is the same whatever the reference's step."""
    rng = np.random.default_rng(5)
    f = rng.random((8, 300)) < 0.2
    adj = _sym_adjacency(rng, 300, 0.03)
    want = np.asarray(j_expand(jnp.asarray(f), jnp.asarray(adj), tk=tk,
                               interpret=True))
    got = ops.bitmap_expand(torch.from_numpy(f), torch.from_numpy(adj))
    assert np.array_equal(got.numpy(), want)


def test_bitmap_expand_is_bfs_step():
    """One level of BFS on a path graph, as the reference's test has it."""
    v = 40
    adj = np.zeros((v, v), bool)
    for i in range(v - 1):
        adj[i, i + 1] = adj[i + 1, i] = True
    f = np.zeros((2, v), bool)
    f[0, 0] = True
    f[1, 20] = True
    want = np.asarray(j_expand(jnp.asarray(f), jnp.asarray(adj), interpret=True))
    got = ops.bitmap_expand(torch.from_numpy(f), torch.from_numpy(adj)).numpy()
    assert np.array_equal(got, want)
    assert got[0].nonzero()[0].tolist() == [1]
    assert got[1].nonzero()[0].tolist() == [19, 21]


@pytest.mark.parametrize("k,v,w", [(17, 70, 90), (40, 128, 128), (5, 33, 1)])
def test_bitmap_expand_dense_matches_packed(k, v, w):
    """The dense expansion is the oracle of the packed one, as in
    ``tests/test_packing.py``, on both packages."""
    rng = np.random.default_rng(6 + k)
    f = rng.random((k, v)) < 0.3
    adj = rng.random((v, w)) < 0.1
    dense = ops.bitmap_expand(torch.from_numpy(f), torch.from_numpy(adj))
    packed = ops.bitmap_expand_packed(torch.from_numpy(f),
                                      pack_bits(torch.from_numpy(adj)), n_cols=w)
    assert torch.equal(dense, packed)
    want = np.asarray(j_expand_packed(jnp.asarray(f), j_pack_bits(jnp.asarray(adj)),
                                      n_cols=w, interpret=True))
    assert np.array_equal(dense.numpy(), want)


def test_bitmap_expand_checks_arguments():
    f = torch.zeros((2, 5), dtype=torch.bool)
    with pytest.raises(ValueError, match="bad shapes"):
        ops.bitmap_expand(f, torch.zeros((4, 3), dtype=torch.bool))
    with pytest.raises(ValueError, match="bool"):
        ops.bitmap_expand(f, torch.zeros((5, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="rank-2"):
        ops.bitmap_expand(f[0], torch.zeros((5, 3), dtype=torch.bool))
    assert not ops.bitmap_expand(torch.zeros((3, 0), dtype=torch.bool),
                                 torch.zeros((0, 4), dtype=torch.bool)).any()


def test_cpu_dispatch_takes_plain_version_and_counts_nothing():
    before = dict(LAUNCHES)
    a = torch.zeros((2, 3), dtype=torch.int32)
    ops.minplus(a, a.T.contiguous())
    ops.bitmap_expand_packed(torch.zeros((2, 32), dtype=torch.bool),
                             torch.zeros((32, 1), dtype=torch.int32), n_cols=32)
    ops.bitmap_expand(torch.zeros((2, 32), dtype=torch.bool),
                      torch.zeros((32, 8), dtype=torch.bool))
    i32 = torch.int32
    ops.hybrid_relay(torch.zeros((2, 4), dtype=torch.bool),
                     torch.zeros((5,), dtype=i32), torch.zeros((0,), dtype=i32),
                     torch.zeros((1,), dtype=i32), torch.zeros((1, 1), dtype=i32))
    assert LAUNCHES == before
    assert set(LAUNCHES) == {"minplus", "bitmap_expand_packed", "bitmap_expand",
                             "hybrid_relay"}


def test_cuda_wrappers_refuse_cpu_tensors():
    a = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        minplus_cuda(a, a.T.contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        bitmap_expand_packed_cuda(torch.zeros((2, 32), dtype=torch.bool),
                                  torch.zeros((32, 1), dtype=torch.int32), 32)
    with pytest.raises(ValueError, match="int32"):
        minplus_cuda(a.to(torch.int64), a.T.contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        bitmap_expand_cuda(torch.zeros((2, 32), dtype=torch.bool),
                           torch.zeros((32, 8), dtype=torch.bool))
    i32 = torch.int32
    with pytest.raises(ValueError, match="CUDA"):
        hybrid_relay_cuda(torch.zeros((2, 4), dtype=torch.bool),
                          torch.zeros((5,), dtype=i32), torch.zeros((0,), dtype=i32),
                          torch.zeros((1,), dtype=i32), torch.zeros((1, 1), dtype=i32))


@pytest.mark.parametrize("v,nw,want", [(128, 4, (8, 2048)), (16, 1, (8, 64)),
                                       (2048, 64, (8, 0)), (300000, 1, (8, 0))])
def test_block_shape(v, nw, want):
    """A warp per frontier row, 8 rows per block; the words are staged in
    shared memory when they fit in 48 KB, else read through L2 (0)."""
    assert block_shape(v, nw) == want


def test_dense_vector_loads_needs_16_byte_rows_and_bases():
    f = torch.zeros((40, 128), dtype=torch.bool)
    a = torch.zeros((128, 128), dtype=torch.bool)
    assert dense_vector_loads(f, a) == (f.data_ptr() % 16 == 0
                                        and a.data_ptr() % 16 == 0)
    assert not dense_vector_loads(torch.zeros((4, 100), dtype=torch.bool),
                                  torch.zeros((100, 128), dtype=torch.bool))
    assert not dense_vector_loads(f, torch.zeros((128, 77), dtype=torch.bool))
    shifted = torch.zeros(128 * 128 + 1, dtype=torch.bool)[1:].view(128, 128)
    assert shifted.is_contiguous() and not dense_vector_loads(f, shifted)
