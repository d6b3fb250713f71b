"""Frontier expansion on the card: the hand-written CUDA kernels
``csrc/bitmap_expand_packed.cu`` (bit-packed adjacency) and
``csrc/bitmap_expand.cu`` (dense bool adjacency) behind checked launch
wrappers.

They replace ``repro.kernels.frontier.bitmap_expand_packed`` (the Pallas
unpack-then-MXU kernel the reference's hybrid relay reaches with
``use_pallas=True``) and ``repro.kernels.frontier.bitmap_expand`` (the
Pallas f32 MXU product behind ``repro.kernels.bitmap_expand``).  The port
has no switch: a CUDA tensor launches the kernel, a CPU tensor takes
``ref.bitmap_expand_packed_ref`` or ``ref.bitmap_expand_ref`` (dispatch in
``kernels.ops``).  See the sources for the designs and bounds.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_DENSE_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
_VEC = 16                # bytes per vector load in csrc/bitmap_expand.cu
_MAX_SMEM = 227 * 1024   # shared memory a Hopper block may use


def _lib():
    lib = _build.load("bitmap_expand_packed")
    lib.bitmap_expand_packed_launch.argtypes = _ARGTYPES
    lib.bitmap_expand_packed_launch.restype = ctypes.c_int
    return lib


def _dense_lib():
    lib = _build.load("bitmap_expand")
    lib.bitmap_expand_launch.argtypes = _DENSE_ARGTYPES
    lib.bitmap_expand_launch.restype = ctypes.c_int
    return lib


def check_expand_args(frontier: torch.Tensor, adj_words: torch.Tensor,
                      n_cols: int) -> None:
    """Shape and dtype rules shared by the kernel and its plain version."""
    if frontier.ndim != 2 or adj_words.ndim != 2:
        raise ValueError("rank-2 inputs required")
    if frontier.shape[1] != adj_words.shape[0]:
        raise ValueError(f"bad shapes {tuple(frontier.shape)} x "
                         f"{tuple(adj_words.shape)}")
    if frontier.dtype != torch.bool or adj_words.dtype != torch.int32:
        raise ValueError(f"want bool frontier and int32 words, got "
                         f"{frontier.dtype}/{adj_words.dtype}")
    if not 0 <= n_cols <= adj_words.shape[1] * 32:
        raise ValueError(f"n_cols={n_cols} exceeds {adj_words.shape[1]} words")


def block_shape(v: int, nw: int) -> tuple[int, int]:
    """(words, rows) per block: words fill up to one warp, rows fill 128
    threads, and the staged frontier rows fit in shared memory."""
    bx = 1
    while bx < min(nw, 32):
        bx *= 2
    by = max(1, 128 // bx)
    if v:
        by = max(1, min(by, _MAX_SMEM // v))
    return bx, by


def bitmap_expand_packed_cuda(frontier: torch.Tensor, adj_words: torch.Tensor,
                              n_cols: int) -> torch.Tensor:
    """(K, V) bool x (V, NW) int32 words -> (K, n_cols) bool, on the card."""
    check_expand_args(frontier, adj_words, n_cols)
    if not (frontier.is_cuda and adj_words.is_cuda) \
            or frontier.device != adj_words.device:
        raise ValueError("bitmap_expand_packed kernel takes tensors on one "
                         "CUDA device")
    if not (frontier.is_contiguous() and adj_words.is_contiguous()):
        raise ValueError("bitmap_expand_packed kernel takes contiguous tensors")
    k, v = frontier.shape
    nw = adj_words.shape[1]
    if v > _MAX_SMEM:
        raise ValueError(f"hub block of {v} vertices exceeds shared memory")
    out = torch.empty((k, n_cols), dtype=torch.bool, device=frontier.device)
    if k == 0 or n_cols == 0:
        return out
    if v == 0:
        return out.zero_()
    bx, by = block_shape(v, nw)
    lib = _lib()
    stream = torch.cuda.current_stream(frontier.device).cuda_stream
    rc = lib.bitmap_expand_packed_launch(
        frontier.data_ptr(), adj_words.data_ptr(), out.data_ptr(),
        k, v, nw, n_cols, bx, by, stream)
    _build.check(lib, rc, "bitmap_expand_packed")
    _build.LAUNCHES["bitmap_expand_packed"] += 1
    return out


def check_dense_expand_args(frontier: torch.Tensor,
                            adjacency: torch.Tensor) -> None:
    """Shape and dtype rules shared by the dense kernel and its plain
    version (the reference's ``bitmap_expand`` checks)."""
    if frontier.ndim != 2 or adjacency.ndim != 2:
        raise ValueError("rank-2 inputs required")
    if frontier.shape[1] != adjacency.shape[0]:
        raise ValueError(f"bad shapes {tuple(frontier.shape)} x "
                         f"{tuple(adjacency.shape)}")
    if frontier.dtype != torch.bool or adjacency.dtype != torch.bool:
        raise ValueError(f"want bool frontier and adjacency, got "
                         f"{frontier.dtype}/{adjacency.dtype}")


def dense_vector_loads(frontier: torch.Tensor, adjacency: torch.Tensor) -> bool:
    """Whether the dense kernel may stage its tiles with 16-byte loads:
    both row pitches and both base addresses are multiples of 16 bytes."""
    return all(x % _VEC == 0 for x in (frontier.shape[1], adjacency.shape[1],
                                        frontier.data_ptr(), adjacency.data_ptr()))


def bitmap_expand_cuda(frontier: torch.Tensor,
                       adjacency: torch.Tensor) -> torch.Tensor:
    """(R, V) bool x (V, W) bool -> (R, W) bool, on the card."""
    check_dense_expand_args(frontier, adjacency)
    if not (frontier.is_cuda and adjacency.is_cuda) \
            or frontier.device != adjacency.device:
        raise ValueError("bitmap_expand kernel takes tensors on one CUDA device")
    if not (frontier.is_contiguous() and adjacency.is_contiguous()):
        raise ValueError("bitmap_expand kernel takes contiguous tensors")
    r, v = frontier.shape
    w = adjacency.shape[1]
    out = torch.empty((r, w), dtype=torch.bool, device=frontier.device)
    if r == 0 or w == 0:
        return out
    if v == 0:
        return out.zero_()
    lib = _dense_lib()
    stream = torch.cuda.current_stream(frontier.device).cuda_stream
    rc = lib.bitmap_expand_launch(frontier.data_ptr(), adjacency.data_ptr(),
                                  out.data_ptr(), r, v, w,
                                  int(dense_vector_loads(frontier, adjacency)),
                                  stream)
    _build.check(lib, rc, "bitmap_expand")
    _build.LAUNCHES["bitmap_expand"] += 1
    return out
