"""Sketches on the card: the hand-written CUDA kernel ``csrc/sketch_batch.cu``
behind a checked launch wrapper.

Replaces, on the serving path, ``repro.kernels.minplus.minplus`` (the Pallas
VPU kernel behind the reference's ``compute_sketch_batch(...,
use_pallas=True)``) together with the array ops around it: Eq. 3's min-plus
contraction and the whole sketch (Definition 4.5) are one launch.  The port
has no switch: a CUDA tensor launches this kernel, a CPU tensor takes
``ref.sketch_batch_ref`` (dispatch in ``kernels.ops``).  See the source for
the design and bound.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_ELEM_BYTES = {torch.uint8: 1, torch.uint16: 2, torch.int32: 4}
_THREADS = 256            # csrc/sketch_batch.cu: threads per block (one query)
_MAX_SMEM = 232448        # the most dynamic shared memory a block may opt in to


def _lib():
    lib = _build.load("sketch_batch")
    lib.sketch_batch_launch.argtypes = _ARGTYPES
    lib.sketch_batch_launch.restype = ctypes.c_int
    return lib


def check_sketch_args(lu: torch.Tensor, lv: torch.Tensor, meta_w: torch.Tensor,
                      meta_dist: torch.Tensor) -> None:
    """Shape rules shared by the kernel and its plain version: rows
    ``(B, R)``, meta tables ``(R, R)``, R >= 1."""
    if lu.ndim != 2 or lv.shape != lu.shape:
        raise ValueError(f"want lu and lv of one (B, R) shape, got "
                         f"{tuple(lu.shape)} and {tuple(lv.shape)}")
    r = lu.shape[1]
    if r < 1 or meta_w.shape != (r, r) or meta_dist.shape != (r, r):
        raise ValueError(f"want R >= 1 and ({r}, {r}) meta tables, got "
                         f"{tuple(meta_w.shape)} and {tuple(meta_dist.shape)}")


def smem_layout(r: int) -> tuple[bool, int]:
    """(staged, dynamic shared-memory bytes) of a block: the rows, the two
    R-bit masks and the warp minima always; the attaining-pair bitmap and
    the two int32 meta tables too while all of it fits in 227 KB, else the
    tables are read through L2 and the bitmap lives in global scratch."""
    nw = (r + 31) // 32
    base = 4 * (2 * r + 2 * nw + _THREADS // 32)
    staged = base + 4 * (r * nw + 2 * r * r)
    if staged <= _MAX_SMEM:
        return True, staged
    if base > _MAX_SMEM:
        raise ValueError(f"R = {r}: the rows alone exceed a block's shared memory")
    return False, base


def sketch_batch_cuda(lu: torch.Tensor, lv: torch.Tensor, meta_w: torch.Tensor,
                      meta_dist: torch.Tensor):
    """The six sketch fields for rows ``(B, R)`` on the card, in the order of
    ``core.sketch.SketchBatch``.  The four inputs share one dtype: uint8 or
    uint16 (packed, sentinel = dtype max) or int32."""
    check_sketch_args(lu, lv, meta_w, meta_dist)
    tensors = (lu, lv, meta_w, meta_dist)
    card = lu.get_device()                # -1 on the CPU
    if card < 0 or not all(t.get_device() == card for t in tensors):
        raise ValueError("sketch_batch kernel takes tensors on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("sketch_batch kernel takes contiguous tensors")
    if lu.dtype not in _ELEM_BYTES or any(t.dtype != lu.dtype for t in tensors):
        raise ValueError(f"sketch_batch kernel takes one dtype of uint8, uint16 "
                         f"and int32, got {[str(t.dtype) for t in tensors]}")
    b, r = lu.shape
    dev = lu.device
    # the int32 fields as views of one buffer: fewer host ops per call
    ints = torch.empty((b * (2 * r + 3),), dtype=torch.int32, device=dev)
    d_top, d_star_u, d_star_v, du_land, dv_land = ints.split_with_sizes(
        (b, b, b, b * r, b * r))
    du_land, dv_land = du_land.view(b, r), dv_land.view(b, r)
    meta_edge = torch.empty((b, r, r), dtype=torch.bool, device=dev)
    out = (d_top, du_land, dv_land, meta_edge, d_star_u, d_star_v)
    if b == 0:
        return out
    staged, smem = smem_layout(r)
    scratch = None if staged else \
        torch.empty((b, r, (r + 31) // 32), dtype=torch.int32, device=dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.sketch_batch_launch(
        *(t.data_ptr() for t in tensors), *(t.data_ptr() for t in out),
        0 if scratch is None else scratch.data_ptr(),
        b, r, _ELEM_BYTES[lu.dtype], int(staged), smem, stream)
    _build.check(lib, rc, "sketch_batch")
    _build.LAUNCHES["sketch_batch"] += 1
    return out
