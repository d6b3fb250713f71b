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


def csr_or(messages: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """OR-reduce per-edge boolean messages ``(K, B)`` whose segment key is
    sorted into ``(K, N)``: ``bounds`` ``(N + 1,)`` holds each segment's
    first edge (and B last).  A zero-led int32 prefix sum of the messages,
    read at the boundaries, counts each segment's true messages; an empty
    segment counts 0 and comes out False.  No atomics: the key is sorted."""
    k, b = messages.shape
    cs = torch.zeros((k, b + 1), dtype=torch.int32, device=messages.device)
    cs[:, 1:] = messages
    cs.cumsum_(dim=1)
    return (cs[:, bounds[1:]] - cs[:, bounds[:-1]]) > 0


def hybrid_relay_ref(f: torch.Tensor, tail_ptr: torch.Tensor,
                     tail_col: torch.Tensor, hub_ids: torch.Tensor,
                     adj_words: torch.Tensor) -> torch.Tensor:
    """The hybrid relay: next[k, w] = OR_{e in tail row w} f[k, tail_col[e]],
    ORed on the hub columns with the hub block's expansion of the hub
    frontier (``bitmap_expand_packed_ref``), from the same CSR rows and hub
    arrays the kernel reads."""
    out = csr_or(f[:, tail_col], tail_ptr)
    hubs = hub_ids.to(torch.int64)
    out[:, hubs] |= bitmap_expand_packed_ref(f[:, hubs], adj_words,
                                             hub_ids.shape[0])
    return out
