"""The recover search's side attach on the card: the hand-written CUDA
kernels of ``csrc/side_attach.cu`` (certificate, closure step, edge pass)
behind a checked launch wrapper that runs the closure's step loop.

They replace no TPU kernel: the reference writes the attach as plain
``jnp`` in ``repro.core.search._side_attach``.  The port has no switch: a
CUDA tensor launches these kernels, a CPU tensor takes
``ref.side_attach_ref`` (dispatch in ``kernels.ops``).  See the source for
the design and bound.
"""
from __future__ import annotations

import ctypes
import weakref

import torch

from .. import trace
from . import _build

SEG_SLOTS = 32              # csrc/side_attach.cu SEG: CSR slots per closure warp
_SMEM = 48 * 1024           # shared memory a block takes without opting in
_P, _I = ctypes.c_void_p, ctypes.c_int
_CERT_ARGTYPES = [_P] * 5 + [_I] * 4 + [_P]
_STEP_ARGTYPES = [_P] * 10 + [_I] * 5 + [_P]
_EDGE_ARGTYPES = [_P] * 7 + [_I] * 4 + [_P]


def _lib():
    lib = _build.load("side_attach")
    for name, types in (("side_attach_certificate_launch", _CERT_ARGTYPES),
                        ("side_attach_closure_launch", _STEP_ARGTYPES),
                        ("side_attach_edges_launch", _EDGE_ARGTYPES)):
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = ctypes.c_int
    return lib


def check_side_attach_args(depth: torch.Tensor, side_land: torch.Tensor,
                           label_dist: torch.Tensor, indptr: torch.Tensor,
                           src: torch.Tensor, dst: torch.Tensor,
                           lid: torch.Tensor, max_chain: int,
                           out: torch.Tensor | None = None) -> None:
    """Shape and dtype rules shared by the kernels and their plain version:
    ``depth`` (B, V) and ``side_land`` (B, R) int32, ``label_dist`` (V, R)
    packed uint8/uint16, the graph's CSR ``indptr`` (V + 1,) and slot ends
    ``src``/``dst`` (E,), ``lid`` (V,), all int32, and ``out`` (B, E) bool
    when given."""
    if depth.ndim != 2 or depth.dtype != torch.int32:
        raise ValueError(f"want a (B, V) int32 depth table, got {depth.dtype} "
                         f"{tuple(depth.shape)}")
    b, v = depth.shape
    if label_dist.dtype not in (torch.uint8, torch.uint16) or label_dist.ndim != 2 \
            or label_dist.shape[0] != v:
        raise ValueError(f"want ({v}, R) packed uint8/uint16 labels, got "
                         f"{label_dist.dtype} {tuple(label_dist.shape)}")
    r = label_dist.shape[1]
    if side_land.dtype != torch.int32 or side_land.shape != (b, r):
        raise ValueError(f"want ({b}, {r}) int32 sigma rows, got "
                         f"{side_land.dtype} {tuple(side_land.shape)}")
    for name, t, shape in (("indptr", indptr, (v + 1,)), ("lid", lid, (v,)),
                           ("src", src, None), ("dst", dst, src.shape)):
        if t.dtype != torch.int32 or t.ndim != 1 or (shape and t.shape != shape):
            raise ValueError(f"{name} must be int32 of shape {shape or '(E,)'}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if out is not None and (out.dtype != torch.bool
                            or out.shape != (b, src.shape[0])):
        raise ValueError(f"want a ({b}, {src.shape[0]}) bool out, got "
                         f"{out.dtype} {tuple(out.shape)}")
    if max_chain < 0:
        raise ValueError(f"max_chain={max_chain} < 0")


def closure_segments(indptr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The closure step's warps, on ``indptr``'s device: warp s pulls slots
    ``seg_beg[s] ..`` (at most ``SEG_SLOTS``, up to the row's end) of row
    ``seg_row[s]``; every slot of every row lies in exactly one segment and
    an empty row has none (both int32)."""
    v = indptr.shape[0] - 1
    n_seg = (indptr.diff() + SEG_SLOTS - 1) // SEG_SLOTS
    rows = torch.repeat_interleave(
        torch.arange(v, dtype=torch.int32, device=indptr.device), n_seg)
    first = (torch.cumsum(n_seg, 0) - n_seg).to(torch.int64)
    rows64 = rows.to(torch.int64)
    k = torch.arange(rows.shape[0], device=indptr.device) - first[rows64]
    beg = indptr.to(torch.int64)[rows64] + SEG_SLOTS * k
    return rows, beg.to(torch.int32)


# indptr's id -> (seg_row, seg_beg); an entry goes when its indptr does, so
# an id is never reused while its entry stands
_SEGMENTS: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}


def cached_segments(indptr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``closure_segments``, computed once per ``indptr`` tensor (a context
    passes the graph's own to every call), so only the first call pays for
    the schedule and its host sync."""
    key = id(indptr)
    hit = _SEGMENTS.get(key)
    if hit is None:
        weakref.finalize(indptr, _SEGMENTS.pop, key, None)
        hit = _SEGMENTS[key] = closure_segments(indptr)
    return hit


def side_attach_cuda(depth: torch.Tensor, side_land: torch.Tensor,
                     label_dist: torch.Tensor, indptr: torch.Tensor,
                     src: torch.Tensor, dst: torch.Tensor, lid: torch.Tensor,
                     max_chain: int, out: torch.Tensor | None = None):
    """One side's attach on the card -> ``(edge_mask (B, E) bool, on (V, W,
    R) int32 words)``; with ``out`` the edges are ORed into it and it is
    returned.  Launches the certificate, one closure step per step (the
    host reads the step's flag, one sync per step, as the plain version
    does) and the edge pass; the kernels only set bits, so the table, the
    activity bitmap and a fresh result start zeroed."""
    check_side_attach_args(depth, side_land, label_dist, indptr, src, dst, lid,
                           max_chain, out)
    tensors = (depth, side_land, label_dist, indptr, src, dst, lid) \
        + (() if out is None else (out,))
    if not all(t.is_cuda and t.device == depth.device for t in tensors):
        raise ValueError("side_attach kernels take tensors on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("side_attach kernels take contiguous tensors")
    b, v = depth.shape
    r = label_dist.shape[1]
    e = src.shape[0]
    if 32 * r * 4 > _SMEM:
        raise ValueError(f"R = {r} landmarks exceed the certificate's shared "
                         f"sigma slice ({_SMEM} bytes)")
    w = (b + 31) // 32
    dev = depth.device
    on = torch.zeros((v, w, r), dtype=torch.int32, device=dev)
    if out is None:
        out = torch.zeros((b, e), dtype=torch.bool, device=dev)
    if b == 0 or v == 0:
        return out, on
    act = torch.zeros(((v + 31) // 32,), dtype=torch.int32, device=dev)
    wide = int(label_dist.dtype == torch.uint16)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream

    rc = lib.side_attach_certificate_launch(
        depth.data_ptr(), side_land.data_ptr(), label_dist.data_ptr(),
        on.data_ptr(), act.data_ptr(), b, v, r, wide, stream)
    _build.check(lib, rc, "side_attach certificate")
    _build.LAUNCHES["side_attach"] += 1

    seg_row, seg_beg = cached_segments(indptr)
    spare = torch.empty_like(on)
    flag = torch.zeros((1,), dtype=torch.int32, device=dev)
    it = 0
    changed = True
    while changed and it < max_chain:
        rc = lib.side_attach_closure_launch(
            on.data_ptr(), spare.data_ptr(), indptr.data_ptr(), dst.data_ptr(),
            label_dist.data_ptr(), lid.data_ptr(), act.data_ptr(),
            seg_row.data_ptr(), seg_beg.data_ptr(), flag.data_ptr(),
            seg_row.shape[0], v, r, w, wide, stream)
        _build.check(lib, rc, "side_attach closure step")
        _build.LAUNCHES["side_attach"] += 1
        on, spare = spare, on
        changed = bool(flag)    # one host sync per closure step
        it += 1
        trace.count("search.closure_steps")
        trace.count("search.host_syncs")

    if e:
        rc = lib.side_attach_edges_launch(
            on.data_ptr(), src.data_ptr(), dst.data_ptr(), label_dist.data_ptr(),
            lid.data_ptr(), act.data_ptr(), out.data_ptr(), b, e, r, wide,
            stream)
        _build.check(lib, rc, "side_attach edge pass")
        _build.LAUNCHES["side_attach"] += 1
    return out, on
