"""Mamba2 (SSD) block in the chunked matmul form, in PyTorch.  Counterpart
of ``repro.models.mamba2``.

The recurrence  h_t = a_t * h_{t-1} + dt_t * B_t x_t^T,  y_t = C_t h_t + D x_t
(scalar decay a_t per head) is evaluated as an intra-chunk masked
decay-weighted (C_t . B_s) matmul plus an O(n_chunks) scan over per-chunk
summarised states (the reference's ``lax.scan``, here a Python loop).  The
single-step ``mamba2_decode`` updates the (heads, head_dim, state)
recurrent state directly.  The scan math is f32, with the reference's
masking of the decay *exponent*, which keeps it finite.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Init


def ssm_dims(cfg):
    d_inner = cfg.d_model * cfg.ssm_expand
    heads = cfg.ssm_heads or max(1, d_inner // 64)
    hd = d_inner // heads
    return d_inner, heads, hd


class Mamba2(nn.Module):
    """``in_proj`` ([z | x | B | C | dt]), the depthwise conv, the decay and
    skip parameters (f32), the gated norm gain and ``out_proj``."""

    def __init__(self, cfg, init: Init):
        super().__init__()
        d_inner, heads, _ = ssm_dims(cfg)
        n, d, f32 = cfg.ssm_state, cfg.d_model, torch.float32
        self.in_proj = init.dense(d, 2 * d_inner + 2 * n * heads + heads)
        self.conv_w = init.normal((cfg.ssm_conv, d_inner), 0.2)
        self.conv_b = init.full((d_inner,), 0.0)
        self.a_log = nn.Parameter(torch.log(torch.linspace(
            1.0, 16.0, heads, dtype=f32, device=init.device)))
        self.d_skip = init.full((heads,), 1.0, f32)
        self.dt_bias = init.full((heads,), 0.0, f32)
        self.norm_g = init.full((d_inner,), 1.0)
        self.out_proj = init.dense(d_inner, d)


def _split_proj(p: Mamba2, x, cfg):
    d_inner, heads, _ = ssm_dims(cfg)
    n = cfg.ssm_state
    zxbcdt = x @ p.in_proj
    z, xs, bc, dt_ = torch.split(
        zxbcdt, [d_inner, d_inner, 2 * n * heads, heads], dim=-1)
    b_, s = x.shape[0], x.shape[1]
    bmat = bc[..., : n * heads].reshape(b_, s, heads, n)
    cmat = bc[..., n * heads:].reshape(b_, s, heads, n)
    dt_ = F.softplus(dt_.float() + p.dt_bias)                 # (B, S, H)
    return z, xs, bmat, cmat, dt_


def _conv(p: Mamba2, xs, cfg, conv_state=None):
    """Short causal depthwise conv; returns (out, new_conv_state)."""
    k = cfg.ssm_conv
    if conv_state is None:
        pad = torch.zeros((xs.shape[0], k - 1, xs.shape[-1]), dtype=xs.dtype,
                          device=xs.device)
    else:
        pad = conv_state
    xp = torch.cat([pad, xs], dim=1)
    new_state = xp[:, -(k - 1):, :]
    w = p.conv_w
    out = sum(xp[:, i: xp.shape[1] - (k - 1) + i, :] * w[i] for i in range(k))
    return F.silu(out + p.conv_b), new_state


def _gated_norm(p: Mamba2, y, z, cfg, dtype):
    y = y * F.silu(z.float())
    y = y * torch.rsqrt((y * y).mean(-1, keepdim=True) + cfg.norm_eps)
    return (y * p.norm_g.float()).to(dtype)


def mamba2_chunked(p: Mamba2, x: torch.Tensor, cfg, chunk: int = 256,
                   state=None, return_state: bool = False):
    """x: (B, S, D).  Optional initial state {ssm (B, H, hd, N), conv}."""
    d_inner, heads, hd = ssm_dims(cfg)
    n = cfg.ssm_state
    b_, s, _ = x.shape
    chunk = min(chunk, s)
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk

    z, xs, bmat, cmat, dt_ = _split_proj(p, x, cfg)
    conv_state = None if state is None else state["conv"]
    xs, new_conv = _conv(p, xs, cfg, conv_state)
    xh = xs.reshape(b_, s, heads, hd).float()

    a = -torch.exp(p.a_log)                        # (H,) negative
    la = dt_ * a[None, None, :]                    # log decay per step
    la = la.reshape(b_, nc, chunk, heads)
    dt_c = dt_.reshape(b_, nc, chunk, heads)
    xc = xh.reshape(b_, nc, chunk, heads, hd)
    bc_ = bmat.reshape(b_, nc, chunk, heads, n).float()
    cc = cmat.reshape(b_, nc, chunk, heads, n).float()

    cum = torch.cumsum(la, dim=2)                  # (B,nc,L,H) log decay to t
    # intra-chunk: y[t] += sum_{s<=t} exp(cum[t]-cum[s]) dt[s] (C_t.B_s) x[s]
    scores = torch.einsum("bnlhs,bnmhs->bnhlm", cc, bc_)       # (B,nc,H,L,L)
    decay = cum[..., :, None, :] - cum[..., None, :, :]         # (B,nc,L,L,H)
    decay = decay.movedim(-1, 2)                                # (B,nc,H,L,L)
    li = torch.arange(chunk, device=x.device)
    mask = li[:, None] >= li[None, :]
    # mask the *exponent* (not the product): exp of the masked upper
    # triangle would overflow
    decay = torch.where(mask[None, None, None], decay, -1e9)
    w = torch.exp(decay) * scores
    y = torch.einsum("bnhlm,bnmh,bnmhd->bnlhd", w, dt_c, xc)

    # chunk summary states and inter-chunk scan
    tail = cum[..., -1:, :] - cum                               # decay to end
    gk = torch.exp(tail)
    chunk_state = torch.einsum("bnlh,bnlh,bnlhs,bnlhd->bnhds",
                               gk, dt_c, bc_, xc)               # (B,nc,H,hd,N)
    chunk_decay = torch.exp(cum[..., -1, :])                    # (B,nc,H)

    h = torch.zeros((b_, heads, hd, n), dtype=torch.float32, device=x.device) \
        if state is None else state["ssm"].float()
    h_in = []
    for c in range(nc):
        h_in.append(h)                             # state entering this chunk
        h = h * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    h_in = torch.stack(h_in, dim=1)                             # (B,nc,H,hd,N)
    # inter-chunk contribution: C_t . (decay_to_t * h_in)
    y = y + torch.einsum("bnlhs,bnlh,bnhds->bnlhd", cc, torch.exp(cum), h_in)

    y = y + p.d_skip[None, None, :, None] * xc
    y = _gated_norm(p, y.reshape(b_, s, d_inner), z, cfg, x.dtype)
    out = y @ p.out_proj
    if return_state:
        return out, {"ssm": h, "conv": new_conv}
    return out


def mamba2_decode(p: Mamba2, x: torch.Tensor, cfg, state):
    """One-step recurrence.  x: (B, 1, D); state {ssm (B,H,hd,N), conv}."""
    d_inner, heads, hd = ssm_dims(cfg)
    z, xs, bmat, cmat, dt_ = _split_proj(p, x, cfg)
    xs, new_conv = _conv(p, xs, cfg, state["conv"])
    xh = xs.reshape(x.shape[0], heads, hd).float()
    a = -torch.exp(p.a_log)
    decay = torch.exp(dt_[:, 0, :] * a[None, :])                # (B,H)
    bm = bmat[:, 0].float()                                     # (B,H,N)
    cm = cmat[:, 0].float()
    h = state["ssm"] * decay[:, :, None, None] + torch.einsum(
        "bh,bhn,bhd->bhdn", dt_[:, 0], bm, xh)
    y = torch.einsum("bhn,bhdn->bhd", cm, h)
    y = y + p.d_skip[None, :, None] * xh
    y = _gated_norm(p, y.reshape(x.shape[0], 1, d_inner), z, cfg, x.dtype)
    return y @ p.out_proj, {"ssm": h, "conv": new_conv}

