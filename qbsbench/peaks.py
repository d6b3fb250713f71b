"""The yardstick's peaks and the operation and byte counts of the kernels
whose roofline share the benchmark reports.

Published figures of one NVIDIA H100 SXM (80 GB HBM3), at its 700 W limit.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def hybrid_relay_bytes(k: int, v: int, e_tail: int, h: int, n_words: int) -> int:
    """The least bytes one ``hybrid_relay`` call moves: the (K, V) bool
    frontier read once and the (K, V) bool result written once, the
    tail's column and row-pointer arrays (int32), the hub ids (int32) and
    the bit-packed hub block (int32 words), each read once."""
    return 2 * k * v + 4 * e_tail + 4 * (v + 1) + 4 * h + 4 * n_words


def hybrid_relay_call_bytes(f, tail_ptr, tail_col, hub_ids, adj_words) -> int:
    """``hybrid_relay_bytes`` of one call, from its arguments' shapes."""
    k, v = f.shape
    return hybrid_relay_bytes(int(k), int(v), int(tail_col.numel()),
                              int(hub_ids.numel()), int(adj_words.numel()))
