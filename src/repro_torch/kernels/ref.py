"""Plain PyTorch versions of the hand-written kernels: the semantics each
kernel must reproduce bit for bit, and what a wrapper runs for a tensor on
the CPU.  Counterpart of ``repro.kernels.ref``."""
from __future__ import annotations

import torch

from ..core.packing import unpack_bits


def minplus_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Min-plus (tropical) product: C[m, n] = min_k (A[m, k] + B[k, n]).
    int32 inputs with INF sentinels (INF + INF stays far below 2**31)."""
    return (a[:, :, None] + b[None, :, :]).amin(dim=1)


def bitmap_expand_ref(frontier: torch.Tensor,
                      adjacency: torch.Tensor) -> torch.Tensor:
    """One level-synchronous BFS expansion over a dense adjacency block:
    next[r, w] = OR_v frontier[r, v] & adjacency[v, w], as the f32 OR-AND
    product thresholded at 0.5 (exact for 0/1 inputs)."""
    return (frontier.to(torch.float32) @ adjacency.to(torch.float32)) > 0.5


def bitmap_expand_packed_ref(frontier: torch.Tensor, adj_words: torch.Tensor,
                             n_cols: int) -> torch.Tensor:
    """next[r, w] = OR_v frontier[r, v] & bit(adj_words[v, w // 32], w % 32):
    unpack the words, then the f32 OR-AND product thresholded at 0.5 (exact
    for 0/1 inputs; the reference's ``_dense_or_matmul``)."""
    adj = unpack_bits(adj_words, n_cols)
    return (frontier.to(torch.float32) @ adj.to(torch.float32)) > 0.5
