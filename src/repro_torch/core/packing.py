"""Packed layouts: narrow distance tables and bit-packed boolean words.

Counterpart of ``repro.core.packing``.

* **Packed distance tables** (``PackedLabels``): the ``(V, R)`` label
  table, the meta-graph tables and the serving lanes' ``(R, V)``
  landmark-distance table stored as ``torch.uint8`` (escape hatch to
  ``torch.uint16`` when the measured diameter reaches 255).  ``INF`` is the
  dtype max, a sentinel; ``widen_dist`` restores exact int32 semantics and
  is the one sanctioned widening point, applied to gathered rows at the
  consumer.
* **Bit-packed reachability words** (``pack_bits`` / ``unpack_bits``):
  ``(..., N)`` bool <-> ``(..., ceil(N/32))`` words, 32 little-endian
  columns per word.  The reference stores uint32; torch has few uint32
  operators, so the port holds the same bit patterns in ``int32`` (compare
  with numpy ``.view(np.uint32)``).  The hybrid frontier's hub-hub block and
  the ``bitmap_expand_packed`` kernel read this layout.

Packing is exact: ``widen_dist(pack_dist(x)) == x`` bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .graph import INF

# Escape-hatch ladder: narrowest first; the dtype max is the INF sentinel.
_PACK_DTYPES = (np.uint8, np.uint16)
_TORCH_OF = {np.dtype(np.uint8): torch.uint8, np.dtype(np.uint16): torch.uint16}
_NP_OF = {v: k for k, v in _TORCH_OF.items()}


def _np_dtype(dtype) -> np.dtype:
    return _NP_OF[dtype] if isinstance(dtype, torch.dtype) else np.dtype(dtype)


def sentinel_of(dtype) -> int:
    """The INF sentinel of a packed dtype (numpy or torch): its maximum."""
    return int(np.iinfo(_np_dtype(dtype)).max)


def _max_finite(a) -> int:
    if isinstance(a, torch.Tensor):
        a = a.to(torch.int32) if a.dtype in _NP_OF else a
        if a.numel() == 0:
            return 0
        return int(torch.where(a < INF, a, 0).max())
    a = np.asarray(a)
    finite = a[a < INF]
    return int(finite.max()) if finite.size else 0


def choose_pack_dtype(*arrays) -> np.dtype:
    """Narrowest packed dtype for a set of int32 distance arrays (tensors or
    numpy; ``None`` entries skipped): uint8 unless the max finite distance
    collides with its sentinel 255, then uint16."""
    m = 0
    for a in arrays:
        if a is not None:
            m = max(m, _max_finite(a))
    for dtype in _PACK_DTYPES:
        if m < sentinel_of(dtype):
            return np.dtype(dtype)
    raise ValueError(
        f"max finite distance {m} collides with the uint16 sentinel "
        f"{sentinel_of(np.uint16)}; no packed layout fits")


def pad_width(n: int) -> int:
    """Smallest ladder width >= ``n`` from {1, 2, 3, 4, 6, 8, 12, 16, ...}."""
    if n <= 1:
        return 1
    p = 1 << (n - 1).bit_length()
    mid = p // 4 * 3
    return mid if n <= mid else p


def pack_dist(a, dtype, *, device=None) -> torch.Tensor:
    """Pack an int32 distance array (INF = no entry) into ``dtype`` with the
    dtype-max sentinel standing in for INF.  Runs where ``a`` lies (or on
    ``device`` for numpy input); raises if a finite value would collide
    with the sentinel."""
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.asarray(a), device=device)
    elif device is not None:
        a = a.to(device)
    sent = sentinel_of(dtype)
    bad = (a >= sent) & (a < INF)
    if bool(bad.any()):
        raise ValueError(
            f"finite distance {int(a[bad].max())} >= sentinel {sent}; "
            f"promote the pack dtype")
    return torch.where(a >= INF, sent, a).to(_TORCH_OF[_np_dtype(dtype)])


def take(table: torch.Tensor, *index: torch.Tensor) -> torch.Tensor:
    """``table[index]`` for a packed (or any) table, on any device.  CUDA
    has no indexing kernel for uint16, so a uint16 table is gathered through
    its int16 view, which holds the same bits, and viewed back."""
    if table.dtype == torch.uint16:
        return table.view(torch.int16)[index].view(torch.uint16)
    return table[index]


def put(table: torch.Tensor, index: tuple, values: torch.Tensor) -> torch.Tensor:
    """A copy of ``table`` with ``copy[index] = values``; ``table`` itself is
    never written (an index of an earlier epoch may still be serving it).
    uint16 tables are written through their int16 view, like ``take``."""
    out = table.clone()
    if out.dtype == torch.uint16:
        out.view(torch.int16)[index] = values.view(torch.int16)
    else:
        out[index] = values
    return out


def widen_dist(a: torch.Tensor) -> torch.Tensor:
    """Widen a (possibly packed) distance tensor to int32 with INF restored:
    signed inputs pass through as int32, uint8/uint16 are sentinel-decoded."""
    if a.dtype not in _NP_OF:
        return a.to(torch.int32)
    a32 = a.to(torch.int32)
    return torch.where(a32 == sentinel_of(a.dtype), INF, a32)


class PackedLabels(NamedTuple):
    """The labelling's distance tables in packed layout, one dtype for all."""

    label_dist: torch.Tensor              # (V, R) uint8/uint16, sentinel = INF
    meta_w: torch.Tensor                  # (R, R) direct meta edge weights
    meta_dist: torch.Tensor               # (R, R) meta-graph APSP
    lm_dist: torch.Tensor | None = None   # (R, V) vertex-to-landmark (serving lanes)

    @property
    def dtype(self) -> np.dtype:
        return _np_dtype(self.label_dist.dtype)

    @property
    def sentinel(self) -> int:
        return sentinel_of(self.label_dist.dtype)

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self if a is not None)


def pack_labelling(scheme, lm_dist=None, *, dtype=None) -> PackedLabels:
    """Pack a ``LabellingScheme`` (and optionally the ``(R, V)`` landmark
    distance table); the dtype is chosen from the max finite distance
    across *all* tables so one sentinel covers the whole index."""
    if dtype is None:
        dtype = choose_pack_dtype(
            scheme.label_dist, scheme.meta_w, scheme.meta_dist, lm_dist)
    return PackedLabels(
        label_dist=pack_dist(scheme.label_dist, dtype),
        meta_w=pack_dist(scheme.meta_w, dtype),
        meta_dist=pack_dist(scheme.meta_dist, dtype),
        lm_dist=None if lm_dist is None else pack_dist(lm_dist, dtype),
    )


def patch_packed(old: PackedLabels, scheme, lm_dist, affected) -> PackedLabels:
    """The packed tables after an incremental labelling update, equal to a
    fresh ``pack_labelling`` of ``(scheme, lm_dist)``.

    ``affected`` holds the landmark indices whose label columns and lm_dist
    rows changed (``update_labelling``'s ``info["affected"]``), ``lm_dist``
    the host ``(R, V)`` int32 table.  The dtype is re-derived from the new
    tables, so a measured diameter crossing the uint8 sentinel forces a
    full repack to uint16 (and one receding below it narrows back).
    Otherwise only the affected label columns and lm_dist rows are packed,
    on the device, and written into copies of the old tables (``put``):
    ``old`` stays as it was.  The (R, R) meta tables are repacked whole.
    """
    dev = old.label_dist.device
    dtype = choose_pack_dtype(scheme.label_dist, scheme.meta_w,
                              scheme.meta_dist, lm_dist)
    if dtype != old.dtype or old.lm_dist is None:
        lm = torch.as_tensor(np.asarray(lm_dist), device=dev)
        return pack_labelling(scheme, lm_dist=lm, dtype=dtype)
    aff = np.asarray(affected, np.int32)
    idx = torch.as_tensor(aff, device=dev).to(torch.int64)
    cols = pack_dist(scheme.label_dist[:, idx], dtype)
    rows = pack_dist(np.asarray(lm_dist)[aff, :], dtype, device=dev)
    return PackedLabels(
        label_dist=put(old.label_dist, (slice(None), idx), cols),
        meta_w=pack_dist(scheme.meta_w, dtype),
        meta_dist=pack_dist(scheme.meta_dist, dtype),
        lm_dist=put(old.lm_dist, (idx,), rows),
    )


def packed_size_bytes(packed: PackedLabels) -> dict:
    """Packed bytes against the int32 layout of the same tables."""
    n_elems = sum(a.numel() for a in packed if a is not None)
    return {
        "packed_bytes": packed.nbytes,
        "int32_bytes": n_elems * 4,
        "dtype": str(packed.dtype),
        "ratio": (n_elems * 4) / max(packed.nbytes, 1),
    }


# ---------------------------------------------------------------------------
# Bit-packed boolean words (hybrid frontier hub block)
# ---------------------------------------------------------------------------


def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """(..., N) bool -> (..., ceil(N/32)) int32 words holding the uint32 bit
    patterns (bit ``i`` of word ``w`` is column ``32 * w + i``)."""
    n = x.shape[-1]
    pad = (-n) % 32
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    x = x.reshape(*x.shape[:-1], -1, 32).to(torch.int32)
    weights = torch.ones((), dtype=torch.int32, device=x.device) << \
        torch.arange(32, dtype=torch.int32, device=x.device)
    # the bits are distinct, so the int32 sum is their OR; bit 31 lands as
    # INT32_MIN and no partial sum overflows
    return (x * weights).sum(dim=-1, dtype=torch.int32)


def unpack_bits(x: torch.Tensor, n: int) -> torch.Tensor:
    """(..., W) int32 words -> (..., n) bool (inverse of ``pack_bits``)."""
    shifts = torch.arange(32, dtype=torch.int32, device=x.device)
    bits = (x.to(torch.int32)[..., :, None] >> shifts) & 1
    return bits.reshape(*x.shape[:-1], -1)[..., :n].to(torch.bool)
