"""Frontier expansion on the card: the hand-written CUDA kernels
``csrc/bitmap_expand_packed.cu`` (bit-packed adjacency),
``csrc/bitmap_expand.cu`` (dense bool adjacency) and
``csrc/hybrid_relay.cu`` (the hybrid relay's tail pull and hub block in one
pass) behind checked launch wrappers.

They replace ``repro.kernels.frontier.bitmap_expand_packed`` (the Pallas
unpack-then-MXU kernel the reference's hybrid relay reaches with
``use_pallas=True``; ``hybrid_relay_cuda`` runs it fused with the tail) and
``repro.kernels.frontier.bitmap_expand`` (the Pallas f32 MXU product behind
``repro.kernels.bitmap_expand``).  The port has no switch: a CUDA tensor
launches the kernel, a CPU tensor takes the plain version in ``ref``
(dispatch in ``kernels.ops``).  See the sources for the designs and bounds.
"""
from __future__ import annotations

import ctypes
import weakref

import torch

from ..core.packing import pack_bits
from . import _build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]
_DENSE_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
_RELAY_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
WARP_ROW_EDGES = 32      # csrc/hybrid_relay.cu: tail rows longer than this get a warp
_VEC = 16                # bytes per vector load in csrc/bitmap_expand.cu
_STAGE_SMEM = 48 * 1024  # shared memory a block takes without opting in
_EXPAND_ROWS = 8         # frontier rows (warps) per block, csrc/bitmap_expand_packed.cu


def _lib():
    lib = _build.load("bitmap_expand_packed")
    lib.bitmap_expand_packed_launch.argtypes = _ARGTYPES
    lib.bitmap_expand_packed_launch.restype = ctypes.c_int
    return lib


def _relay_lib():
    lib = _build.load("hybrid_relay")
    lib.hybrid_relay_launch.argtypes = _RELAY_ARGTYPES
    lib.hybrid_relay_launch.restype = ctypes.c_int
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
    """(frontier rows, shared-memory bytes) per block: a warp per row, and
    the (V, NW) words staged when they fit in 48 KB (0 = read through L2)."""
    words = v * nw * 4
    return _EXPAND_ROWS, (words if 0 < words <= _STAGE_SMEM else 0)


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
    out = torch.empty((k, n_cols), dtype=torch.bool, device=frontier.device)
    if k == 0 or n_cols == 0:
        return out
    if v == 0:
        return out.zero_()
    _, smem = block_shape(v, nw)
    lib = _lib()
    stream = torch.cuda.current_stream(frontier.device).cuda_stream
    rc = lib.bitmap_expand_packed_launch(
        frontier.data_ptr(), adj_words.data_ptr(), out.data_ptr(),
        k, v, nw, n_cols, smem, stream)
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


def check_relay_args(f: torch.Tensor, tail_ptr: torch.Tensor,
                     tail_col: torch.Tensor, hub_ids: torch.Tensor,
                     adj_words: torch.Tensor) -> None:
    """Shape and dtype rules shared by the fused relay kernel and its plain
    version: ``f`` (K, V) bool, the tail's CSR rows ``tail_ptr`` (V + 1,)
    and ``tail_col`` (E_tail,), ``hub_ids`` (H,) and the hub block's words
    ``adj_words`` (H, ceil(H / 32)), all int32."""
    if f.ndim != 2 or f.dtype != torch.bool:
        raise ValueError(f"want a (K, V) bool frontier, got {f.dtype} "
                         f"{tuple(f.shape)}")
    v = f.shape[1]
    h = hub_ids.shape[0] if hub_ids.ndim == 1 else -1
    for name, t in (("tail_ptr", tail_ptr), ("tail_col", tail_col),
                    ("hub_ids", hub_ids), ("adj_words", adj_words)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if tail_ptr.shape != (v + 1,) or tail_col.ndim != 1:
        raise ValueError(f"want tail_ptr ({v + 1},) and a 1-D tail_col, got "
                         f"{tuple(tail_ptr.shape)} and {tuple(tail_col.shape)}")
    if h < 1 or adj_words.ndim != 2 or adj_words.shape[0] != h \
            or adj_words.shape[1] * 32 < h:
        raise ValueError(f"want hub_ids (H,) and adj_words (H, ceil(H/32)), "
                         f"got {tuple(hub_ids.shape)} and "
                         f"{tuple(adj_words.shape)}")


def relay_schedule(tail_ptr: torch.Tensor,
                   hub_ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Which rows the fused relay's warps pull, on the arrays' device:
    ``warp_rows`` int32 holds the hubs in hub order (warp i < H is hub i,
    which also ORs row i of the hub block) and then every other tail row
    longer than ``WARP_ROW_EDGES``; ``warp_bits`` marks the same rows in a
    (ceil(V / 32),) int32 bitmap, and a lane leaves a marked row alone."""
    v = tail_ptr.shape[0] - 1
    by_warp = torch.zeros((v,), dtype=torch.bool, device=tail_ptr.device)
    by_warp[hub_ids.long()] = True
    long_rows = torch.nonzero((tail_ptr.diff() > WARP_ROW_EDGES) & ~by_warp)[:, 0]
    by_warp[long_rows] = True
    return torch.cat([hub_ids, long_rows.to(torch.int32)]), pack_bits(by_warp)


# tail_ptr's id -> (hub_ids, warp_rows, warp_bits); an entry goes when its
# tail_ptr does, so an id is never reused while its entry stands
_SCHEDULES: dict[int, tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}


def cached_schedule(tail_ptr: torch.Tensor,
                    hub_ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``relay_schedule``, computed once per ``tail_ptr`` tensor: an engine
    passes the same arrays to every relay, so only its first pays for the
    schedule (and the host sync of its ``nonzero``)."""
    key = id(tail_ptr)
    hit = _SCHEDULES.get(key)
    if hit is None or hit[0] is not hub_ids:
        if hit is None:
            weakref.finalize(tail_ptr, _SCHEDULES.pop, key, None)
        hit = (hub_ids, *relay_schedule(tail_ptr, hub_ids))
        _SCHEDULES[key] = hit
    return hit[1], hit[2]


def hybrid_relay_cuda(f: torch.Tensor, tail_ptr: torch.Tensor,
                      tail_col: torch.Tensor, hub_ids: torch.Tensor,
                      adj_words: torch.Tensor) -> torch.Tensor:
    """(K, V) bool -> (K, V) bool, the hybrid relay on the card, with the
    warp schedule of ``cached_schedule``."""
    check_relay_args(f, tail_ptr, tail_col, hub_ids, adj_words)
    k, v = f.shape
    h = hub_ids.shape[0]
    tensors = (f, tail_ptr, tail_col, hub_ids, adj_words)
    if not all(t.is_cuda and t.device == f.device for t in tensors):
        raise ValueError("hybrid_relay kernel takes tensors on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("hybrid_relay kernel takes contiguous tensors")
    out = torch.empty((k, v), dtype=torch.bool, device=f.device)
    if k == 0 or v == 0:
        return out
    warp_rows, warp_bits = cached_schedule(tail_ptr, hub_ids)
    ft = torch.empty((v, (k + 31) // 32), dtype=torch.int32, device=f.device)
    vec = v % 4 == 0 and f.data_ptr() % 4 == 0
    lib = _relay_lib()
    stream = torch.cuda.current_stream(f.device).cuda_stream
    rc = lib.hybrid_relay_launch(
        f.data_ptr(), tail_ptr.data_ptr(), tail_col.data_ptr(),
        hub_ids.data_ptr(), adj_words.data_ptr(), warp_rows.data_ptr(),
        warp_bits.data_ptr(), ft.data_ptr(), out.data_ptr(),
        k, v, h, adj_words.shape[1], warp_rows.shape[0], int(vec), stream)
    _build.check(lib, rc, "hybrid_relay")
    _build.LAUNCHES["hybrid_relay"] += 1
    return out
