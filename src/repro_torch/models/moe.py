"""Mixture-of-Experts layer: top-k router with GShard-style capacity
dispatch, in PyTorch.  Counterpart of ``repro.models.moe``.

``moe_onehot`` is the one-hot dispatch/combine einsum formulation;
``moe_sort`` the sort/scatter dispatch with the same routing semantics.
Every serving call is dropless (capacity covers every routed assignment),
so a token's expert output does not depend on its batch, and prefill plus
decode reproduces the full-sequence forward; capacity dropping is a
training trade.

Routing matches the reference's bits: the router runs in f32, top-k is a
stable descending sort (``jax.lax.top_k`` breaks ties toward the lower
expert index; ``torch.topk`` makes no promise), the per-expert order is a
stable sort and the bucket starts a left-side ``searchsorted``.  The
combine is an ``index_add_``: with ``top_k <= 2`` each output row is
``0 + a + b``, the same bits in any order; with more it is a float sum
whose order on the card is not fixed.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Init


class MoE(nn.Module):
    """Router (f32, ``(D, E)``) and stacked expert SwiGLU weights
    ``wg wu (E, D, F)``, ``wd (E, F, D)``."""

    def __init__(self, cfg, init: Init):
        super().__init__()
        e, d, f = cfg.moe_experts, cfg.d_model, cfg.d_ff
        self.router = init.dense(d, e, torch.float32, scale=0.02)
        self.wg = init.normal((e, d, f), d ** -0.5)
        self.wu = init.normal((e, d, f), d ** -0.5)
        self.wd = init.normal((e, f, d), f ** -0.5)


def moe_capacity(cfg, n_tokens: int) -> int:
    cap = int(n_tokens * cfg.moe_top_k * cfg.moe_capacity_factor / cfg.moe_experts)
    return max(8, (cap + 7) // 8 * 8)


def _route(p: MoE, xt: torch.Tensor, k: int):
    """f32 router softmax and the top-k experts per token, ties to the
    lower index (a stable descending sort, as ``lax.top_k``)."""
    logits = xt.float() @ p.router
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :k], idx[..., :k]
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    return probs, gate_vals, gate_idx


def _aux_loss(probs, gate_idx, e: int, n: int, k: int) -> torch.Tensor:
    """Switch-style load-balancing loss over every token."""
    me = probs.reshape(-1, e).mean(dim=0)
    ce = torch.bincount(gate_idx.reshape(-1), minlength=e).float() / (n * k)
    return e * torch.sum(me * ce)


def moe(p: MoE, x: torch.Tensor, cfg, *, dropless: bool = False):
    # dropless always dispatches via sort: the one-hot dispatch tensor
    # scales quadratically with the dropless capacity
    if dropless or cfg.moe_dispatch == "sort":
        return moe_sort(p, x, cfg, dropless=dropless)
    return moe_onehot(p, x, cfg)


def moe_onehot(p: MoE, x: torch.Tensor, cfg, *, dropless: bool = False):
    """x: (B, S, D) -> (out, aux_loss).  Dispatch via one-hot einsums, in
    groups of ``moe_group_size`` tokens (0 = one global group)."""
    b, s, d = x.shape
    n = b * s
    e, k = cfg.moe_experts, cfg.moe_top_k
    m = min(cfg.moe_group_size or n, n)
    g = n // m
    if g * m != n:
        g, m = 1, n
    cap = m if dropless else moe_capacity(cfg, m)
    xt = x.reshape(g, m, d)

    probs, gate_vals, gate_idx = _route(p, xt, k)             # (G, m, k)
    aux = _aux_loss(probs, gate_idx, e, n, k)

    # position of each (token, choice) inside its expert's per-group buffer
    onehot = F.one_hot(gate_idx, e).to(torch.int32)           # (G, m, k, E)
    flat = onehot.reshape(g, m * k, e)
    pos_in_expert = torch.cumsum(flat, dim=1) * flat - 1
    pos = pos_in_expert.amax(dim=-1).reshape(g, m, k)
    keep = (pos < cap) & (pos >= 0)
    gate_vals = gate_vals * keep

    pos_c = torch.clamp(pos, 0, cap - 1)
    disp = (F.one_hot(gate_idx, e).to(xt.dtype)[..., None]
            * F.one_hot(pos_c, cap).to(xt.dtype)[:, :, :, None, :]
            * keep[..., None, None].to(xt.dtype))             # (G, m, k, E, cap)
    disp_tok = disp.sum(dim=2)                                # (G, m, E, cap)
    xe = torch.einsum("gmd,gmec->gecd", xt, disp_tok)         # (G, E, cap, D)

    h = F.silu(torch.einsum("gecd,edf->gecf", xe, p.wg))
    h = h * torch.einsum("gecd,edf->gecf", xe, p.wu)
    ye = torch.einsum("gecf,efd->gecd", h, p.wd)

    combine = torch.einsum("gmkec,gmk->gmec", disp, gate_vals.to(xt.dtype))
    out = torch.einsum("gmec,gecd->gmd", combine, ye)
    return out.reshape(b, s, d), aux


def moe_sort(p: MoE, x: torch.Tensor, cfg, *, dropless: bool = False):
    """Sort/scatter dispatch: O(N*k*d) data movement, no N^2 one-hot
    matmuls; the stable sort keeps each expert's token order, so the same
    overflow tokens drop as in ``moe_onehot``."""
    b, s, d = x.shape
    n = b * s
    e, k = cfg.moe_experts, cfg.moe_top_k
    # tight static dropless bound: distinct top_k => <= n slots per expert
    cap = n if dropless else moe_capacity(cfg, n)
    xt = x.reshape(n, d)

    probs, gate_vals, gate_idx = _route(p, xt, k)             # (N, k)
    aux = _aux_loss(probs, gate_idx, e, n, k)

    e_flat = gate_idx.reshape(-1)
    g_flat = gate_vals.reshape(-1)
    order = torch.sort(e_flat, stable=True).indices
    sorted_e = e_flat[order]
    tok_of = order // k
    start = torch.searchsorted(sorted_e, torch.arange(e, device=x.device))
    pos = torch.arange(n * k, device=x.device) - start[sorted_e]
    keep = pos < cap
    dest = torch.where(keep, sorted_e * cap + pos, e * cap)   # overflow slot

    xe = torch.zeros((e * cap + 1, d), dtype=xt.dtype, device=x.device)
    xe[dest] = xt[tok_of]
    xe = xe[:-1].reshape(e, cap, d)

    h = F.silu(torch.einsum("ecd,edf->ecf", xe, p.wg))
    h = h * torch.einsum("ecd,edf->ecf", xe, p.wu)
    ye = torch.einsum("ecf,efd->ecd", h, p.wd).reshape(e * cap, d)

    contrib = ye[torch.clamp(dest, 0, e * cap - 1)] * (
        g_flat[order] * keep).to(ye.dtype)[:, None]
    out = torch.zeros((n, d), dtype=ye.dtype, device=x.device)
    out.index_add_(0, tok_of, contrib)
    return out.reshape(b, s, d).to(x.dtype), aux
