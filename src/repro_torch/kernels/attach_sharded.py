"""The sharded general lane's side attach (phase E1 of
``core.sharded.general_lane``) on the cards: the hand-written CUDA kernels
of ``csrc/sharded_attach.cu`` (certificate, closure step, edge pass), one
launch per shard, behind checked launch wrappers, and the loop
(``drive``) that runs them over a mesh with one word-table exchange and
one host wait per closure step for all landmarks.

They replace no TPU kernel: the reference writes the attach as plain
``jnp``.  The port has no switch: CUDA tensors launch these kernels, CPU
tensors take ``ref.sharded_attach_ref`` (dispatch in ``kernels.ops``).
They share no code with ``csrc/side_attach.cu``: a shard holds only its
destination-owned in-edges, int32 labels and sources that other shards
own.  See the source for the design and bound.
"""
from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import trace
from . import _build
from .attach import closure_segments

_SMEM = 48 * 1024           # shared memory a block takes without opting in
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_CERT_ARGTYPES = [_P, _I] + [_P] * 4 + [_I] * 3 + [_P]
_STEP_ARGTYPES = [_P] * 13 + [_I] * 6 + [_P]
_EDGE_ARGTYPES = [_P] * 9 + [_I, _I, _L] + [_I] * 5 + [_P]


class AttachPlan(NamedTuple):
    """What the kernels read of an index, made once (``make_attach_plan``);
    one entry per shard, on its device."""

    src: list       # (E,) int32 global sources (the partition's)
    dst: list       # (E,) int32 local destinations, sorted, pads v_loc last
    indptr: list    # (v_loc + 1,) int32: row y's in-slots are indptr[y]..
    seg_row: list   # int32: the closure's warps (``attach.closure_segments``)
    seg_beg: list
    lid: list       # (V,) int32 landmark index of each vertex, or -1
    vstart: list    # (S,) int32 first vertex of each shard's block
    v_loc: int


class AttachInputs(NamedTuple):
    """One chunk's E1 inputs, one entry per shard.  The kernels read the
    first four; the plain version reads them all."""

    sides: list      # (2B, v_loc + 1) int32: u sides' depths, then v sides'
    sigma: list      # (2B, R) int32: du_land rows, then dv_land rows
    labels: list     # (v_loc, R) int32 label block (pad rows INF)
    label_src: list  # (E, R) int32 labels of the slots' sources
    label_dst: list  # (E, R) int32 labels of the slots' destinations
    dst_l: list      # (E,) int64 local destinations
    src_lid: list    # (E,) int64 landmark index of the source, or -1
    dst_lid: list    # (E,) int64 landmark index of the destination, or -1
    gm_e: list       # (E,) bool: a valid slot with both ends off the landmarks


def make_attach_plan(src_sh, dst_sh, vstart: np.ndarray, v_loc: int,
                     landmarks_sh, n_vertices: int) -> AttachPlan:
    """The in-edge CSR of each shard (a ``searchsorted`` of its sorted local
    destinations; pad slots, which target ``v_loc``, lie past the last
    row), its closure segments, and the landmark ids and block starts, on
    each shard's device.  Raises if a shard's destinations are unsorted."""
    plan = {k: [] for k in ("indptr", "seg_row", "seg_beg", "lid", "vstart")}
    for dst, lms in zip(dst_sh, landmarks_sh):
        dev = dst.device
        if dst.numel() > 1 and not bool((dst[1:] >= dst[:-1]).all()):
            raise ValueError("a shard's slots must be sorted by local destination")
        rows = torch.arange(v_loc + 1, dtype=dst.dtype, device=dev)
        indptr = torch.searchsorted(dst, rows).to(torch.int32)
        seg_row, seg_beg = closure_segments(indptr)
        lid = torch.full((n_vertices,), -1, dtype=torch.int32, device=dev)
        lid[lms.to(dev, torch.int64)] = torch.arange(lms.shape[0], dtype=torch.int32,
                                                     device=dev)
        for k, x in zip(plan, (indptr, seg_row, seg_beg, lid,
                               torch.as_tensor(vstart, dtype=torch.int32, device=dev))):
            plan[k].append(x)
    return AttachPlan(src=list(src_sh), dst=list(dst_sh), v_loc=v_loc, **plan)


def check_sharded_attach_args(plan: AttachPlan, inp: AttachInputs,
                              max_chain: int) -> None:
    """Shape and dtype rules of the kernels, per shard: ``sides`` (2B, v_loc
    + 1), ``sigma`` (2B, R), ``labels`` (v_loc, R), ``label_src`` (E, R),
    the plan's ``src``/``dst`` (E,), ``indptr`` (v_loc + 1,), ``lid`` (V,)
    and ``vstart`` (S,), all int32."""
    if max_chain < 0:
        raise ValueError(f"max_chain={max_chain} < 0")
    n = len(plan.src)
    vl = plan.v_loc
    for s in range(n):
        sides, sigma = inp.sides[s], inp.sigma[s]
        if sides.dtype != torch.int32 or sides.ndim != 2 or sides.shape[1] != vl + 1 \
                or sides.shape[0] % 2:
            raise ValueError(f"want (2B, {vl + 1}) int32 sides, got {sides.dtype} "
                             f"{tuple(sides.shape)}")
        b2 = sides.shape[0]
        if sigma.dtype != torch.int32 or sigma.ndim != 2 or sigma.shape[0] != b2:
            raise ValueError(f"want ({b2}, R) int32 sigma rows, got {sigma.dtype} "
                             f"{tuple(sigma.shape)}")
        r = sigma.shape[1]
        e = plan.src[s].shape[0]
        for name, t, shape in (("labels", inp.labels[s], (vl, r)),
                               ("label_src", inp.label_src[s], (e, r)),
                               ("src", plan.src[s], (e,)), ("dst", plan.dst[s], (e,)),
                               ("indptr", plan.indptr[s], (vl + 1,)),
                               ("lid", plan.lid[s], None),
                               ("vstart", plan.vstart[s], (n,))):
            if t.dtype != torch.int32 or (shape and tuple(t.shape) != shape) \
                    or (shape is None and t.ndim != 1):
                raise ValueError(f"{name} must be int32 of shape {shape or '(V,)'}, "
                                 f"got {t.dtype} {tuple(t.shape)}")


def _shard_tensors(plan: AttachPlan, inp: AttachInputs, s: int):
    return (inp.sides[s], inp.sigma[s], inp.labels[s], inp.label_src[s],
            plan.src[s], plan.dst[s], plan.indptr[s], plan.seg_row[s],
            plan.seg_beg[s], plan.lid[s], plan.vstart[s])


def check_placement(plan: AttachPlan, inp: AttachInputs) -> None:
    """The kernels take contiguous tensors, each shard's on one CUDA
    device."""
    for s in range(len(plan.src)):
        ts = _shard_tensors(plan, inp, s)
        if not all(t.is_contiguous() for t in ts):
            raise ValueError("sharded_attach kernels take contiguous tensors")
        if not all(t.is_cuda and t.device == ts[0].device for t in ts):
            raise ValueError("sharded_attach kernels take each shard's tensors "
                             "on one CUDA device")
        if 32 * ts[1].shape[1] * 4 > _SMEM:
            raise ValueError(f"R = {ts[1].shape[1]} landmarks exceed the "
                             f"certificate's shared sigma slice ({_SMEM} bytes)")


def _lib():
    lib = _build.load("sharded_attach")
    for name, types in (("sharded_attach_certificate_launch", _CERT_ARGTYPES),
                        ("sharded_attach_closure_launch", _STEP_ARGTYPES),
                        ("sharded_attach_edges_launch", _EDGE_ARGTYPES)):
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = ctypes.c_int
    return lib


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def certificate_cuda(sides, sigma, labels, on, act) -> None:
    """Kernel 1 on one shard: sets the certified words of ``on`` (vpad, W,
    R) and the bits of ``act`` (vpad / 32,), both zeroed by the caller."""
    lib = _lib()
    with torch.cuda.device(on.device):
        rc = lib.sharded_attach_certificate_launch(
            sides.data_ptr(), sides.shape[1], sigma.data_ptr(), labels.data_ptr(),
            on.data_ptr(), act.data_ptr(), sides.shape[0], labels.shape[0],
            sigma.shape[1], _stream(on))
    _build.check(lib, rc, "sharded_attach certificate")
    _build.LAUNCHES["sharded_attach"] += 1


def closure_cuda(s, plan, inp, on, act, table, tact, flag) -> None:
    """Kernel 2 on shard ``s``: one Jacobi step, pulling from the gathered
    snapshot ``table`` (S vpad, W, R) / ``tact`` into the shard's own ``on``
    and ``act`` in place; ``flag`` (1,) int32 is set to 1 if a bit was new
    (the launch zeroes it first)."""
    lib = _lib()
    vpad, w, r = on.shape
    with torch.cuda.device(on.device):
        rc = lib.sharded_attach_closure_launch(
            table.data_ptr(), tact.data_ptr(), on.data_ptr(), act.data_ptr(),
            plan.indptr[s].data_ptr(), plan.src[s].data_ptr(),
            inp.label_src[s].data_ptr(), inp.labels[s].data_ptr(),
            plan.lid[s].data_ptr(), plan.vstart[s].data_ptr(),
            plan.seg_row[s].data_ptr(), plan.seg_beg[s].data_ptr(),
            flag.data_ptr(), plan.seg_row[s].shape[0], len(plan.src), s, vpad, r,
            w * r, _stream(on))
    _build.check(lib, rc, "sharded_attach closure step")
    _build.LAUNCHES["sharded_attach"] += 1


def edges_cuda(s, plan, inp, table, tact, out) -> None:
    """Kernel 3 on shard ``s``: the edge pass from the final gathered table
    into ``out`` (B, E) bool, zeroed by the caller."""
    lib = _lib()
    b, e = out.shape
    vpad = table.shape[0] // len(plan.src)
    with torch.cuda.device(out.device):
        rc = lib.sharded_attach_edges_launch(
            table.data_ptr(), tact.data_ptr(), plan.src[s].data_ptr(),
            plan.dst[s].data_ptr(), inp.label_src[s].data_ptr(),
            inp.labels[s].data_ptr(), plan.lid[s].data_ptr(),
            plan.vstart[s].data_ptr(), out.data_ptr(), b, 2 * b, e, len(plan.src),
            s, plan.v_loc, vpad, table.shape[2], _stream(out))
    _build.check(lib, rc, "sharded_attach edge pass")
    _build.LAUNCHES["sharded_attach"] += 1


class Kernels(NamedTuple):
    """The three per-shard launches ``drive`` makes."""

    certificate: Callable
    closure: Callable
    edges: Callable


CUDA = Kernels(certificate_cuda, closure_cuda, edges_cuda)


def drive(mesh, halo, plan: AttachPlan, inp: AttachInputs, max_chain: int,
          kernels: Kernels = CUDA) -> list:
    """E1 over the mesh -> each shard's ``(B, E)`` bool certified edges.

    Per shard the certificate; then the words and act bits are all-gathered
    raw (``halo.words``) and each closure step pulls from that snapshot,
    the shards' flags reduced once (``mesh.psum``, the step's one host
    wait) and the new words gathered again only after a step that moved
    some shard's set.  A step that moved nothing leaves the tables equal to
    their last gather, which the edge pass then reads.  Landmarks and rows
    that have converged are fixed points of the step and every column still
    moving has taken the same steps, so ``max_chain`` cuts each chain where
    the plain version's per-landmark loop cuts it.  Counts
    ``sharded.closure_steps`` and one ``sharded.host_syncs`` per step."""
    b2, r = inp.sigma[0].shape
    w = (b2 + 31) // 32
    wloc = (plan.v_loc + 31) // 32
    on, act = [], []
    for sides, sigma, labels in zip(inp.sides, inp.sigma, inp.labels):
        dev = sides.device
        on.append(torch.zeros((32 * wloc, w, r), dtype=torch.int32, device=dev))
        act.append(torch.zeros((wloc,), dtype=torch.int32, device=dev))
        kernels.certificate(sides, sigma, labels, on[-1], act[-1])
    table, tact = halo.words(on, act)
    for _ in range(max_chain):
        flags = [torch.zeros((1,), dtype=torch.int32, device=x.device) for x in on]
        for s in range(mesh.n_shards):
            kernels.closure(s, plan, inp, on[s], act[s], table[s].flatten(0, 1),
                            tact[s].flatten(), flags[s])
        trace.count("sharded.closure_steps")
        trace.count("sharded.host_syncs")
        if not bool(mesh.psum(flags)[0]):
            break       # a fixed point: the gathered tables are final
        table, tact = halo.words(on, act)
    del on, act
    out = []
    for s in range(mesh.n_shards):
        o = torch.zeros((b2 // 2, plan.src[s].shape[0]), dtype=torch.bool,
                        device=table[s].device)
        kernels.edges(s, plan, inp, table[s].flatten(0, 1), tact[s].flatten(), o)
        out.append(o)
    return out


def sharded_attach_cuda(mesh, halo, plan: AttachPlan, inp: AttachInputs,
                        max_chain: int) -> list:
    """E1 on the cards (``drive`` with the CUDA kernels), after the checks."""
    check_sharded_attach_args(plan, inp, max_chain)
    check_placement(plan, inp)
    return drive(mesh, halo, plan, inp, max_chain)
