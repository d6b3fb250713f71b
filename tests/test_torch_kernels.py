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
from repro_torch.kernels.sketch import sketch_batch_cuda


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
    ops.sketch_batch(a, a, torch.zeros((3, 3), dtype=i32),
                     torch.zeros((3, 3), dtype=i32))
    assert LAUNCHES == before
    assert set(LAUNCHES) == {"minplus", "sketch_batch", "bitmap_expand_packed",
                             "bitmap_expand", "hybrid_relay"}


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
        sketch_batch_cuda(a, a, torch.zeros((3, 3), dtype=i32),
                          torch.zeros((3, 3), dtype=i32))
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


# A numpy model of csrc/bitmap_expand.cu's data movement: the staged tiles,
# the __byte_perm transpose of the adjacency tile, the ldmatrix.x4 fragments,
# the m16n8k32 s8 MMA, the early exit and the split of V over a cluster
# whose blocks OR their per-output bits.  The kernel runs only on the card;
# this holds its layout to the reference here.
_TM, _TN, _TK, _PITCH, _SPLIT_MAX = 64, 32, 128, 144, 8


def _byte_perm(x, y, sel):
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + \
          [(y >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 0xF] << (8 * i)
    return out


def _bytes_to_bits(x):
    x = x | (x >> 4)
    x = x | (x >> 2)
    x = x | (x >> 1)
    return x & 0x01010101


def _ldmatrix_x4(words, rows, cols):
    """Four 8x8 b16 matrices; lane l gives the row address of matrix l // 8
    (``rows``, ``cols`` in bytes) and gets, from each matrix, the 4 bytes of
    its row l // 4 at byte 4 * (l % 4)."""
    lanes = np.arange(32)
    out = np.zeros((32, 4), np.uint32)
    for m in range(4):
        src = m * 8 + lanes // 4
        out[:, m] = words[rows[src], (cols[src] + 4 * (lanes % 4)) // 4]
    return out


def _s8(regs):
    return regs.astype("<u4").view(np.int8).reshape(*regs.shape, 4).astype(np.int64)


def _mma(acc, a, b0, b1):
    """acc[lane, 4] += A (16 x 32) @ B (32 x 8) from the s8 fragments."""
    lanes = np.arange(32)
    g, t = lanes // 4, lanes % 4
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    av, bv0, bv1 = _s8(a), _s8(b0), _s8(b1)
    for i in range(4):
        A[g, 4 * t + i] = av[:, 0, i]
        A[g + 8, 4 * t + i] = av[:, 1, i]
        A[g, 16 + 4 * t + i] = av[:, 2, i]
        A[g + 8, 16 + 4 * t + i] = av[:, 3, i]
        B[4 * t + i, g] = bv0[:, i]
        B[16 + 4 * t + i, g] = bv1[:, i]
    C = A @ B
    acc += np.stack([C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t],
                     C[g + 8, 2 * t + 1]], axis=1)


def _expand_block(f, adj, m0, n0, k_first, n_chunks):
    """One block's counts > 0 as (TM, TN) bools, its range of V walked in
    TK stages with the early exit."""
    r_n, v_n = f.shape
    w_n = adj.shape[1]
    acc = np.zeros((4, 32, 4, 4), np.int64)          # warp, lane, n8 tile, c
    lanes = np.arange(32)
    g, tig = lanes // 4, lanes % 4
    rows = m0 + np.arange(4)[:, None, None, None] * 16 + g[None, :, None, None] \
        + (np.arange(4)[None, None, None, :] >> 1) * 8
    cols = n0 + np.arange(4)[None, None, :, None] * 8 + tig[None, :, None, None] * 2 \
        + (np.arange(4)[None, None, None, :] & 1)
    valid = (rows < r_n) & (cols < w_n)
    for kt in range(n_chunks):
        k0 = (k_first + kt) * _TK
        a_s = np.zeros((_TM, _PITCH), np.uint8)
        fr = f[m0:m0 + _TM, k0:k0 + _TK]
        a_s[:fr.shape[0], :fr.shape[1]] = fr
        b_s = np.zeros((_TK, _TN), np.uint8)
        ad = adj[k0:k0 + _TK, n0:n0 + _TN]
        b_s[:ad.shape[0], :ad.shape[1]] = ad
        bw = b_s.view("<u4").astype(np.uint32)         # (TK, TN / 4)
        bt = np.zeros((_TN, _PITCH // 4), np.uint32)
        for kg in range(_TK // 4):
            a, b, c, d = (_bytes_to_bits(bw[4 * kg + i]) for i in range(4))
            lo, hi = _byte_perm(a, b, 0x5140), _byte_perm(a, b, 0x7362)
            clo, chi = _byte_perm(c, d, 0x5140), _byte_perm(c, d, 0x7362)
            for i, w in enumerate((_byte_perm(lo, clo, 0x5410), _byte_perm(lo, clo, 0x7632),
                                   _byte_perm(hi, chi, 0x5410), _byte_perm(hi, chi, 0x7632))):
                bt[4 * np.arange(_TN // 4) + i, kg] = w
        aw = a_s.view("<u4").astype(np.uint32)
        for warp in range(4):
            if m0 + warp * 16 >= r_n or n0 >= w_n:
                continue
            a_row = warp * 16 + (lanes & 7) + ((lanes >> 3) & 1) * 8
            a_col = (lanes >> 4) * 16
            b_row = (lanes & 7) + (lanes >> 4) * 8
            b_col = ((lanes >> 3) & 1) * 16
            for kk in range(0, _TK, 32):
                fa = _bytes_to_bits(_ldmatrix_x4(aw, a_row, a_col + kk))
                b01 = _ldmatrix_x4(bt, b_row, b_col + kk)
                b23 = _ldmatrix_x4(bt, 16 + b_row, b_col + kk)
                for t, (bb, h) in enumerate(((b01, 0), (b01, 2), (b23, 0), (b23, 2))):
                    sub = acc[warp, :, t, :]
                    _mma(sub, fa, bb[:, h], bb[:, h + 1])
                    acc[warp, :, t, :] = sub
        if ((acc > 0) | ~valid).all():                   # the early exit
            break
    hit = np.zeros((_TM, _TN), bool)
    hit[rows - m0, cols - n0] = acc > 0
    return hit


def _expand_model(f, adj, n_sm=132):
    r_n, v_n = f.shape
    w_n = adj.shape[1]
    gx, gy = -(-w_n // _TN), -(-r_n // _TM)
    chunks = -(-v_n // _TK)
    split = min(_SPLIT_MAX, chunks, max(1, -(-2 * n_sm // (gx * gy))))
    per_block = -(-chunks // split)
    split = -(-chunks // per_block)
    out = np.full((r_n, w_n), 7, np.uint8)              # 7: never written
    for by in range(gy):
        for bx in range(gx):
            m0, n0 = by * _TM, bx * _TN
            hits = [_expand_block(f, adj, m0, n0, z * per_block,
                                  min(chunks - z * per_block, per_block))
                    for z in range(split)]
            for q in range(split):                       # block q's rows
                for row in range(q, _TM, split):
                    if m0 + row < r_n:
                        word = np.any([h[row] for h in hits], axis=0)
                        n = min(_TN, w_n - n0)
                        out[m0 + row, n0:n0 + n] = word[:n]
    return out, split


@pytest.mark.parametrize("r,v,w,want_split", [(17, 33, 65, 1), (40, 128, 128, 1),
                                              (70, 300, 33, 3), (40, 1000, 70, 8),
                                              (3, 2100, 5, 6)])
def test_bitmap_expand_kernel_model(r, v, w, want_split):
    """Bool bytes of 0, 1, 2 and 255; V split over 1 to 8 blocks."""
    rng = np.random.default_rng(r + v + w)
    vals = np.array([0, 1, 2, 255], np.uint8)
    fb = vals[rng.choice(4, size=(r, v), p=[0.9, 0.04, 0.03, 0.03])]
    ab = vals[rng.choice(4, size=(v, w), p=[0.96, 0.02, 0.01, 0.01])]
    got, split = _expand_model(fb, ab)
    assert split == want_split
    want = np.asarray(j_expand(jnp.asarray(fb != 0), jnp.asarray(ab != 0),
                               interpret=True))
    assert np.array_equal(got, want.astype(np.uint8))


def test_load_builds_and_binds_each_library_once_across_threads(monkeypatch):
    """A first launch from a streaming clock's timer thread and one from the
    main thread race into ``_build.load``: under its lock the build step
    runs once and both threads get the same bound library (the build and
    the binding are stubbed; nothing is compiled here)."""
    import threading
    import time

    from repro_torch.kernels import _build

    builds = []

    def slow_build(names):
        builds.append(tuple(names))
        time.sleep(0.05)                  # wide enough for the race to show

    class FakeLib:
        qbs_error_string = type("Fn", (), {})()

    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "build_all", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: FakeLib())
    start = threading.Barrier(4)
    got = []

    def first_launch():
        start.wait()
        got.append(_build.load("hybrid_relay"))

    threads = [threading.Thread(target=first_launch) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert builds == [("hybrid_relay",)]
    assert len(got) == 4 and all(lib is got[0] for lib in got)
    assert _build.load("hybrid_relay") is got[0]
