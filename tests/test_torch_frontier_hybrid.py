"""Port vs reference: the hybrid relay as one fused call.

``make_relay(backend="hybrid")`` builds the tail as CSR rows
(``tail_ptr``/``tail_col``) and the hub block as words; ``ops.hybrid_relay``
takes its plain version on this CPU, which reads the same arrays as the CUDA
kernel (whose warp schedule ``kernels.frontier.relay_schedule`` derives
from them).
Each is held against the reference's hybrid engine with its Pallas
``bitmap_expand_packed`` in interpret mode (``use_pallas=True,
interpret=True``): at K in {1, 31, 32, 33, 40, 65} (1, 2 and 3 words of
frontier bits a vertex), masked and unmasked, with 1, 5, 128 and all
vertices as hubs.  A numpy model of the kernel's schedule and bit layout
(pack, warp rows, lanes, unpack) is held to the same answers.  Every
comparison is exact, with zero tolerance: the relay is boolean.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import frontier as jf  # noqa: E402
from repro.core import graph as jg  # noqa: E402
from repro_torch.core import frontier as tf  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core.packing import pack_bits, unpack_bits  # noqa: E402
from repro_torch.kernels import frontier as kf  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


def _graphs():
    return {
        # the graphs of tests/test_torch_frontier.py
        "gnp": (jg.gnp_random_graph(50, 3.0, seed=4),
                tg.gnp_random_graph(50, 3.0, seed=4, device="cpu")),
        "ba": (jg.barabasi_albert_graph(70, 2, seed=1),
               tg.barabasi_albert_graph(70, 2, seed=1, device="cpu")),
        "padded": (jg.grid_graph(5, 6, pad_vertices_to=33, pad_edges_to=120),
                   tg.grid_graph(5, 6, pad_vertices_to=33, pad_edges_to=120,
                                 device="cpu")),
        # more vertices than 128 hubs, isolated vertices, and a self-loop
        # padding row longer than a warp
        "ba_padded": (jg.barabasi_albert_graph(300, 3, seed=2, pad_vertices_to=310,
                                               pad_edges_to=1850),
                      tg.barabasi_albert_graph(300, 3, seed=2, pad_vertices_to=310,
                                               pad_edges_to=1850, device="cpu")),
    }


GRAPHS = _graphs()
KS = [1, 31, 32, 33, 40, 65]
HUBS = [1, 5, 128, "all"]


def _n_hubs(name, hubs):
    return GRAPHS[name][0].n_vertices + 3 if hubs == "all" else hubs


def _mask(name, masked):
    if not masked:
        return None
    gj = GRAPHS[name][0]
    lms = jg.select_landmarks(gj, 5)      # the G- shape: f[src] & f[dst]
    keep = np.ones((gj.n_vertices,), bool)
    keep[lms] = False
    return keep[np.asarray(gj.src)] & keep[np.asarray(gj.dst)]


@functools.lru_cache(maxsize=None)
def _engines(name, masked, hubs):
    gj, gt = GRAPHS[name]
    mask = _mask(name, masked)
    nh = _n_hubs(name, hubs)
    ej = jf.make_relay(gj, backend="hybrid", edge_mask=mask, n_hubs=nh,
                       use_pallas=True, interpret=True)
    et = tf.make_relay(gt, backend="hybrid", edge_mask=mask, n_hubs=nh)
    return ej, et


def _frontier(name, k):
    v = GRAPHS[name][0].n_vertices
    return np.random.default_rng(100 + k).random((k, v)) < 0.15


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("hubs", HUBS)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_hybrid_relay_matches_reference(name, masked, hubs, k):
    ej, et = _engines(name, masked, hubs)
    f = _frontier(name, k)
    want = np.asarray(ej.relay(jnp.asarray(f)))
    got = et.relay(torch.from_numpy(f))
    assert got.dtype == torch.bool and got.shape == f.shape
    assert np.array_equal(got.numpy(), want)
    if k == 1:   # the 1-D form (bfs_depths)
        assert np.array_equal(et.relay(torch.from_numpy(f[0])).numpy(), want[0])


@pytest.mark.parametrize("hubs", HUBS)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_tail_rows_are_the_reference_tail(name, masked, hubs):
    """``tail_ptr``/``tail_col`` are the CSR rows of the reference's compacted
    tail edge list ``tail_src``/``tail_dst``, self-loop padding included."""
    ej, et = _engines(name, masked, hubs)
    v = GRAPHS[name][0].n_vertices
    ptr = et.arrays["tail_ptr"].numpy()
    col = et.arrays["tail_col"].numpy()
    assert et.arrays["tail_ptr"].dtype == torch.int32 == et.arrays["tail_col"].dtype
    assert ptr.shape == (v + 1,) and ptr[0] == 0 and ptr[-1] == col.shape[0]
    src_j = np.asarray(ej.arrays.get("tail_src", np.zeros((0,), np.int32)))
    dst_j = np.asarray(ej.arrays.get("tail_dst", np.zeros((0,), np.int32)))
    assert np.array_equal(np.repeat(np.arange(v), np.diff(ptr)), src_j)
    assert np.array_equal(col, dst_j)


@pytest.mark.parametrize("hubs", HUBS)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_hub_columns_are_the_block_transpose(name, masked, hubs):
    """The kernel pulls hub p's column of the block from the block's row p:
    the stored words equal the packed transpose, and the reference's."""
    ej, et = _engines(name, masked, hubs)
    words = et.arrays["adj_hh_words"]
    h = et.arrays["hub_ids"].shape[0]
    adj = unpack_bits(words, h)
    assert torch.equal(words, pack_bits(adj.T.contiguous()))
    assert np.array_equal(words.numpy().view(np.uint32),
                          np.asarray(ej.arrays["adj_hh_words"]))


@pytest.mark.parametrize("hubs", HUBS)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_warp_schedule_covers_each_row_once(name, masked, hubs):
    """Warp i < H pulls hub i; the other warp rows are exactly the non-hub
    rows longer than ``WARP_ROW_EDGES``; ``warp_bits`` marks the same rows,
    which the lanes skip."""
    _, et = _engines(name, masked, hubs)
    a = et.arrays
    v = GRAPHS[name][0].n_vertices
    h = a["hub_ids"].shape[0]
    warp_rows, warp_bits = kf.relay_schedule(a["tail_ptr"], a["hub_ids"])
    rows = warp_rows.numpy()
    assert warp_rows.dtype == torch.int32 == warp_bits.dtype
    assert warp_bits.shape == ((v + 31) // 32,)
    assert np.array_equal(rows[:h], a["hub_ids"].numpy())
    deg = np.diff(a["tail_ptr"].numpy())
    is_hub = np.zeros((v,), bool)
    is_hub[rows[:h]] = True
    assert np.array_equal(rows[h:], np.flatnonzero((deg > kf.WARP_ROW_EDGES) & ~is_hub))
    assert np.unique(rows).size == rows.size
    marked = unpack_bits(warp_bits, v).numpy()
    assert np.array_equal(np.flatnonzero(marked), np.sort(rows))


def _kernel_model(f, a):
    """The fused kernel's data flow in numpy: pack f into (V, W) 32-bit words
    (bit k % 32 of word k // 32), pull each warp row (and, for warp i < H,
    the hub term from row i of the block) and each lane row, then unpack."""
    k, v = f.shape
    w = -(-k // 32)
    fk = np.zeros((w * 32, v), bool)
    fk[:k] = f
    ft = (fk.reshape(w, 32, v).astype(np.uint64)
          << np.arange(32, dtype=np.uint64)[None, :, None]).sum(1).T   # (V, W)
    ptr, col = a["tail_ptr"].numpy(), a["tail_col"].numpy()
    hub_ids = a["hub_ids"].numpy()
    adj = a["adj_hh_words"].numpy().view(np.uint32)
    warp_rows, warp_bits = kf.relay_schedule(a["tail_ptr"], a["hub_ids"])
    rows = warp_rows.numpy()
    by_warp = unpack_bits(warp_bits, v).numpy()
    nt = np.zeros((v, w), np.uint64)
    for x in np.flatnonzero(~by_warp):                     # lanes
        nt[x] = np.bitwise_or.reduce(ft[col[ptr[x]:ptr[x + 1]]], axis=0) \
            if ptr[x + 1] > ptr[x] else 0
    for i, x in enumerate(rows):                           # warps
        acc = np.zeros((w,), np.uint64)
        for e in range(ptr[x], ptr[x + 1]):
            acc |= ft[col[e]]
        if i < hub_ids.size:
            for hh in range(hub_ids.size):
                if (int(adj[i, hh // 32]) >> (hh % 32)) & 1:
                    acc |= ft[hub_ids[hh]]
        nt[x] = acc
    bits = (nt.T[:, None, :] >> np.arange(32, dtype=np.uint64)[None, :, None]) & 1
    return bits.reshape(w * 32, v)[:k].astype(bool)


@pytest.mark.parametrize("k", [1, 33, 65])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["ba", "ba_padded"])
def test_kernel_schedule_model_matches_reference(name, masked, k):
    ej, et = _engines(name, masked, 5)
    f = _frontier(name, k)
    want = np.asarray(ej.relay(jnp.asarray(f)))
    assert np.array_equal(_kernel_model(f, et.arrays), want)


def test_hybrid_relay_checks_arguments():
    _, et = _engines("ba", False, 5)
    a = et.arrays
    args = [a["tail_ptr"], a["tail_col"], a["hub_ids"], a["adj_hh_words"]]
    f = torch.zeros((3, 70), dtype=torch.bool)
    assert not ops.hybrid_relay(f, *args).any()
    with pytest.raises(ValueError, match="bool"):
        ops.hybrid_relay(f.to(torch.uint8), *args)
    with pytest.raises(ValueError, match="tail_ptr"):
        ops.hybrid_relay(torch.zeros((3, 69), dtype=torch.bool), *args)
    with pytest.raises(ValueError, match="int32"):
        ops.hybrid_relay(f, args[0].long(), *args[1:])
    with pytest.raises(ValueError, match="adj_words"):
        ops.hybrid_relay(f, *args[:3], args[3][:2])


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_schedule_is_cached_per_tail_ptr(name):
    """The wrapper's schedule is computed once per ``tail_ptr`` tensor, again
    for other hub ids, and its entry goes with the tensor."""
    _, et = _engines(name, False, 5)
    a = et.arrays
    tail_ptr = a["tail_ptr"].clone()
    first = kf.cached_schedule(tail_ptr, a["hub_ids"])
    again = kf.cached_schedule(tail_ptr, a["hub_ids"])
    assert first[0] is again[0] and first[1] is again[1]
    for got, want in zip(first, kf.relay_schedule(a["tail_ptr"], a["hub_ids"])):
        assert torch.equal(got, want)
    other = a["hub_ids"][:1].clone()
    rows, _ = kf.cached_schedule(tail_ptr, other)
    assert torch.equal(rows, kf.relay_schedule(tail_ptr, other)[0])
    key = id(tail_ptr)
    assert key in kf._SCHEDULES
    del tail_ptr
    assert key not in kf._SCHEDULES
