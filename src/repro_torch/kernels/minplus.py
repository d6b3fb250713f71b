"""Min-plus (tropical) product on the card: the hand-written CUDA kernel
``csrc/minplus.cu`` behind a checked launch wrapper.

Replaces ``repro.kernels.minplus.minplus`` (the Pallas VPU kernel).  The
reference reaches it with ``use_pallas=True``; the port has no switch: a
CUDA tensor launches this kernel, a CPU tensor takes ``ref.minplus_ref``
(dispatch in ``kernels.ops``).  See the source for the design and bound.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_UNSIGNED = (torch.bool, torch.uint8, torch.uint16, torch.uint32, torch.uint64)


def _lib():
    lib = _build.load("minplus")
    lib.minplus_launch.argtypes = _ARGTYPES
    lib.minplus_launch.restype = ctypes.c_int
    return lib


def check_minplus_args(a: torch.Tensor, b: torch.Tensor) -> None:
    """Shape and dtype rules shared by the kernel and its plain version."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad shapes {tuple(a.shape)} x {tuple(b.shape)}")
    if a.dtype in _UNSIGNED or b.dtype in _UNSIGNED:
        # packed uint8/uint16 tables must widen first (sentinel + sentinel
        # wraps in the narrow dtype): core.packing.widen_dist
        raise ValueError(
            f"minplus on dtypes {a.dtype}/{b.dtype}; widen packed tables "
            f"with core.packing.widen_dist before the contraction")
    if a.shape[1] == 0:
        raise ValueError("minplus needs K >= 1")


def minplus_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A (min, +) B on the card; (M, K) x (K, N) int32 -> (M, N) int32."""
    check_minplus_args(a, b)
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise ValueError(f"minplus kernel takes int32, got {a.dtype}/{b.dtype}")
    if not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError("minplus kernel takes two tensors on one CUDA device")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("minplus kernel takes contiguous tensors")
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    if m == 0 or n == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = lib.minplus_launch(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                            m, k, n, stream)
    _build.check(lib, rc, "minplus")
    _build.LAUNCHES["minplus"] += 1
    return out
