"""Inputs for the sharded attach (``kernels.ops.sharded_attach``, phase E1 of
``core.sharded.general_lane``) and a model of its CUDA kernels in PyTorch,
shared by the CPU tests and the card's tests.  Imports neither JAX nor the
JAX package.

``index`` builds a vertex-sharded index on a small Barabasi-Albert graph
with BFS balls cut short (``max_levels``), so that the anchor-chain
closure has work to do.  ``both_paths`` replaces the seam for a while with
a function that runs the plain version and a kernel path on the same
inputs, records both results and hands the lane the kernel path's.

``MODEL`` computes what ``csrc/sharded_attach.cu`` computes, launch by
launch and the way it computes it: int32 words ``(vpad, W, R)`` and an act
bitmap per shard, the certificate per word with INF sigma as -1, the
closure as Jacobi steps over ``attach.closure_segments``' warps of the
shard's in-edge CSR pulling only sources active in the gathered act and off
the landmark set, the decrement tested from the slot's source label and
the destination's own, new bits into the shard's own table and act, the
flag; and the edge pass per slot from the final gathered table, skipping
pads and slots with neither end active, folding row b + B onto row b.
"""
from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch

from repro_torch.core.graph import INF
from repro_torch.core.packing import pack_bits, unpack_bits
from repro_torch.kernels import ops, ref
from repro_torch.kernels import attach_sharded as sa
from repro_torch.kernels.attach import SEG_SLOTS


def index(n_shards: int, max_chain: int, *, device="cpu", n: int = 240,
          seed: int = 5, max_levels: int = 1, devices=None):
    """A ``ShardedIndex`` over ``n_shards`` shards of ``device`` (or one per
    entry of ``devices``) on an ``n``-vertex BA graph (m = 2), built on
    ``device``, with 6 landmarks."""
    from repro_torch.core import barabasi_albert_graph
    from repro_torch.core.mesh import Mesh
    from repro_torch.core.sharded import ShardedIndex

    g = barabasi_albert_graph(n, 2, seed=seed, device=device)
    mesh = Mesh(devices or [device] * n_shards)
    return ShardedIndex.build(g, n_landmarks=6, mesh=mesh,
                              max_levels=max_levels, max_chain=max_chain)


def pairs(idx, b: int, seed: int = 0):
    """``b`` pairs of distinct non-landmark vertices, on the index's device."""
    rng = np.random.default_rng(seed)
    non = np.flatnonzero(~idx._is_landmark_np)
    us, vs = rng.choice(non, b), rng.choice(non, b)
    vs = np.where(us == vs, non[(np.searchsorted(non, vs) + 1) % non.size], vs)
    t = lambda a: torch.as_tensor(a, dtype=torch.int32, device=idx.device)  # noqa: E731
    return t(us), t(vs)


class Record:
    """What ``both_paths`` saw, per call of the seam."""

    def __init__(self):
        self.plain, self.kernel, self.steps = [], [], []


@contextmanager
def both_paths(kernels=None):
    """While open, ``ops.sharded_attach`` runs the plain version and the
    kernels' mesh loop (``drive``) with ``kernels`` (``MODEL``, or the CUDA
    kernels when None) on the same inputs; yields the ``Record``.  The lane
    goes on with the kernel path's edges."""
    rec = Record()
    seam = ops.sharded_attach

    def run(mesh, halo, plan, inp, max_chain):
        rec.plain.append(ref.sharded_attach_ref(mesh, halo, inp, max_chain))
        steps = []
        k = kernels or sa.CUDA

        def closure(s, *a):
            if s == 0:
                steps.append(1)
            return k.closure(s, *a)

        sa.check_sharded_attach_args(plan, inp, max_chain)
        got = sa.drive(mesh, halo, plan, inp, max_chain, sa.Kernels(
            k.certificate, closure, k.edges))
        rec.kernel.append(got)
        rec.steps.append(len(steps))
        return got

    ops.sharded_attach = run
    try:
        yield rec
    finally:
        ops.sharded_attach = seam


# ---------------------------------------------------------------------------
# The model of the three kernels
# ---------------------------------------------------------------------------


def _gathered_row(g: torch.Tensor, vstart: torch.Tensor, vpad: int) -> torch.Tensor:
    """Global vertex ids -> rows of the gathered tables: the last shard whose
    block starts at or before the id (a scan over the non-decreasing
    ``vstart``, as the kernels run it)."""
    g = g.to(torch.int64)
    vs = vstart.to(torch.int64)
    h = (g[:, None] >= vs[None, 1:]).sum(dim=1)
    return h * vpad + g - vs[h]


def _bits_of(words: torch.Tensor) -> torch.Tensor:
    return unpack_bits(words, 32 * words.shape[0])


def _or_reduce(words: torch.Tensor, dim: int) -> torch.Tensor:
    acc = words.select(dim, 0).clone()
    for i in range(1, words.shape[dim]):
        acc |= words.select(dim, i)
    return acc


def certificate(sides, sigma, labels, on, act):
    vloc, r = labels.shape
    s = torch.where(sigma < INF, sigma, -1).to(torch.int64)        # (2B, R)
    d = sides[:, :vloc].to(torch.int64)[:, :, None]                 # (2B, V, 1)
    lab = labels.to(torch.int64)[None]                              # (1, V, R)
    bits = (d < INF) & (lab < INF) & (d + lab == s[:, None, :])     # (2B, V, R)
    on[:vloc] = pack_bits(bits.permute(1, 2, 0)).transpose(1, 2)
    rows = torch.zeros((on.shape[0],), dtype=torch.bool)
    rows[:vloc] = (on[:vloc] != 0).flatten(1).any(dim=1)
    act |= pack_bits(rows)


def closure(s, plan, inp, on, act, table, tact, flag):
    vpad, w, r = on.shape
    vst = plan.vstart[s]
    lid, src, indptr = plan.lid[s], plan.src[s], plan.indptr[s]
    labels, lsrc = inp.labels[s], inp.label_src[s]
    live_src = _bits_of(tact)
    flag.zero_()
    for y, beg in zip(plan.seg_row[s].tolist(), plan.seg_beg[s].tolist()):
        if int(lid[int(vst[s]) + y]) >= 0:
            continue
        es = torch.arange(beg, min(beg + SEG_SLOTS, int(indptr[y + 1])))
        g = src[es].to(torch.int64)
        rows = _gathered_row(g, vst, vpad)
        keep = (lid[g] < 0) & live_src[rows]
        es, rows = es[keep], rows[keep]
        if not es.numel():
            continue
        ly, lx = labels[y][None], lsrc[es]                          # (1, R), (k, R)
        dec = (ly < INF) & (lx < INF) & (ly + 1 == lx)
        acc = _or_reduce(torch.where(dec[:, None, :], table[rows], 0), 0)  # (W, R)
        fresh = acc & ~table[s * vpad + y]
        if bool((fresh != 0).any()):
            on[y] |= fresh
            act[y // 32] |= torch.tensor(1, dtype=torch.int32) << (y % 32)
            flag[0] = 1


def edges(s, plan, inp, table, tact, out):
    n = len(plan.src)
    vpad, w, r = table.shape[0] // n, table.shape[1], table.shape[2]
    b = out.shape[0]
    vst = plan.vstart[s]
    lid = plan.lid[s]
    src = plan.src[s].to(torch.int64)
    dst = plan.dst[s].to(torch.int64)
    valid = dst < plan.v_loc
    y = torch.where(valid, dst, 0)
    xr = _gathered_row(src, vst, vpad)
    yr = s * vpad + y
    live = _bits_of(tact)
    ax, ay = live[xr] & valid, live[yr] & valid
    rx, ry = lid[src].to(torch.int64), lid[int(vst[s]) + y].to(torch.int64)
    lx, ly = inp.label_src[s], inp.labels[s][y]                     # (E, R)
    ox, oy = table[xr], table[yr]                                   # (E, W, R)
    interior = (ax & ay & (rx < 0) & (ry < 0))[:, None] & (lx < INF) & (ly < INF) \
        & (ly + 1 == lx)
    acc = _or_reduce(torch.where(interior[:, None, :], ox & oy, 0), 2)   # (E, W)
    e_idx = torch.arange(src.shape[0])
    rin, rout = ry.clamp(min=0), rx.clamp(min=0)
    hop_in = ax & (ry >= 0) & (lx[e_idx, rin] == 1)
    hop_out = ay & (rx >= 0) & (ly[e_idx, rout] == 1)
    acc |= torch.where(hop_in[:, None], ox[e_idx, :, rin], 0)
    acc |= torch.where(hop_out[:, None], oy[e_idx, :, rout], 0)
    bits = unpack_bits(acc, 2 * b)                                  # (E, 2B)
    out |= (bits[:, :b] | bits[:, b:]).T


MODEL = sa.Kernels(certificate, closure, edges)
