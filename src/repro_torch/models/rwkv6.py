"""RWKV-6 "Finch" block in PyTorch: time-mix with data-dependent per-channel
decay, and channel-mix, in chunked matmul form.  Counterpart of
``repro.models.rwkv6``.

Recurrence (per head, d_k x d_v state S):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

Within a chunk of L = 64 steps the pair decay prod_{s<r<t} w_r factorises
as cumw_{t-1} / cumw_s; both factors are centred by half the chunk's total
log decay and clipped, as in the reference, which keeps them finite in
f32.  The inter-chunk state scan (``lax.scan`` in the reference) is a
Python loop; decode is the plain one-step recurrence.

Dtype promotion follows the reference: the token-shift mixers are f32, so
``feats @ W`` runs in f32 against the bf16 weight (JAX promotes the
weight; torch refuses mixed operands, so the weight is cast here).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Init

LORA = 64


def rwkv_dims(cfg):
    heads = cfg.d_model // cfg.rwkv_head_dim
    return heads, cfg.rwkv_head_dim


class RWKV6(nn.Module):
    """Time-mix (``mix wr wk wv wg wo w0 w_lora_a w_lora_b u ln_g``) and
    channel-mix (``ck cv cr cmix``) weights of one layer."""

    def __init__(self, cfg, init: Init):
        super().__init__()
        d, f32 = cfg.d_model, torch.float32
        heads, hd = rwkv_dims(cfg)
        self.mix = init.uniform((5, d), f32)   # token-shift weights: r,k,v,w,g
        self.wr = init.dense(d, d)
        self.wk = init.dense(d, d)
        self.wv = init.dense(d, d)
        self.wg = init.dense(d, d)
        self.wo = init.dense(d, d)
        self.w0 = init.full((d,), -0.6, f32)
        self.w_lora_a = init.dense(d, LORA, f32, scale=0.01)
        self.w_lora_b = init.dense(LORA, d, f32, scale=0.01)
        self.u = init.normal((heads, hd), 0.1, f32)
        self.ln_g = init.full((d,), 1.0, f32)
        self.ck = init.dense(d, cfg.d_ff)
        self.cv = init.dense(cfg.d_ff, d)
        self.cr = init.dense(d, d)
        self.cmix = init.full((2, d), 0.5, f32)


def _token_shift(x, last):
    """Shift right by one; ``last`` (B, 1, D) is the previous block state."""
    return torch.cat([last, x[:, :-1, :]], dim=1)


def _time_mix_inputs(p: RWKV6, x, last):
    xs = _token_shift(x, last)
    mix = p.mix[:, None, None, :]
    feats = x[None] * mix + xs[None] * (1.0 - mix)          # (5, B, S, D) f32
    r = feats[0] @ p.wr.float()
    k = feats[1] @ p.wk.float()
    v = feats[2] @ p.wv.float()
    g = feats[4] @ p.wg.float()
    wln = torch.tanh(feats[3].float() @ p.w_lora_a) @ p.w_lora_b
    # log decay in [-e, -3e-4]: bounded so a 64-step chunk's cumulative
    # decay range stays factorizable in f32 after centering
    logw = -torch.exp(torch.clamp(p.w0 + wln, -8.0, 1.0))
    return r, k, v, g, logw


def _group_norm_gate(p: RWKV6, y, g, cfg, b_, s, d):
    heads, hd = rwkv_dims(cfg)
    yh = y.reshape(b_, s, heads, hd)
    yh = yh * torch.rsqrt((yh * yh).mean(-1, keepdim=True) + cfg.norm_eps)
    return (yh.reshape(b_, s, d) * p.ln_g) * F.silu(g.float())


def rwkv6_time_mix(p: RWKV6, x: torch.Tensor, cfg, chunk: int = 64,
                   state=None, return_state: bool = False):
    b_, s, d = x.shape
    heads, hd = rwkv_dims(cfg)
    chunk = min(chunk, s)
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk

    last = torch.zeros((b_, 1, d), dtype=x.dtype, device=x.device) \
        if state is None else state["shift"]
    r, k, v, g, logw = _time_mix_inputs(p, x, last)

    rh = r.reshape(b_, nc, chunk, heads, hd).float()
    kh = k.reshape(b_, nc, chunk, heads, hd).float()
    vh = v.reshape(b_, nc, chunk, heads, hd).float()
    lw = logw.reshape(b_, nc, chunk, heads, hd)

    cum = torch.cumsum(lw, dim=2)         # inclusive log cumdecay within chunk
    cum_ex = cum - lw                     # exclusive (decay applied before t)
    # intra-chunk pair decay exp(cum_ex[t] - cum[s]): centre both exponents
    # by half the chunk's total log decay, clip for a safety margin
    shift = 0.5 * cum[..., -1:, :, :]                           # (B,nc,1,H,hd)
    q_dec = rh * torch.exp(torch.clamp(cum_ex - shift, -80.0, 80.0))
    k_dec = kh * torch.exp(torch.clamp(shift - cum, -80.0, 80.0))
    scores = torch.einsum("bnlhd,bnmhd->bnhlm", q_dec, k_dec)
    li = torch.arange(chunk, device=x.device)
    mask = li[:, None] > li[None, :]                            # strict s < t
    scores = torch.where(mask[None, None, None], scores, 0.0)
    y = torch.einsum("bnhlm,bnmhd->bnlhd", scores, vh)
    # bonus current-token term: r_t . diag(u) k_t v_t
    bonus = torch.einsum("bnlhd,hd,bnlhd->bnlh", rh, p.u, kh)
    y = y + bonus[..., None] * vh

    # inter-chunk state scan: S_end = diag(prod w) S_in + sum_s decay k_s v_s
    tail = cum[..., -1:, :, :] - cum
    kv = torch.einsum("bnlhd,bnlhe->bnhde", kh * torch.exp(tail), vh)
    cdecay = torch.exp(cum[..., -1, :, :])                      # (B,nc,H,hd)

    h = torch.zeros((b_, heads, hd, hd), dtype=torch.float32, device=x.device) \
        if state is None else state["wkv"].float()
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = h * cdecay[:, c, :, :, None] + kv[:, c]
    h_in = torch.stack(h_in, dim=1)                             # (B,nc,H,hd,hd)
    # inter-chunk readout uses the *uncentered* decay (<= 1, overflow-free)
    q_inter = rh * torch.exp(cum_ex)
    y = y + torch.einsum("bnlhd,bnhde->bnlhe", q_inter, h_in)

    y = _group_norm_gate(p, y.reshape(b_, s, d), g, cfg, b_, s, d)
    out = y.to(x.dtype) @ p.wo
    if return_state:
        return out, {"wkv": h, "shift": x[:, -1:, :]}
    return out


def rwkv6_time_mix_decode(p: RWKV6, x: torch.Tensor, cfg, state):
    """x: (B, 1, D); state {wkv (B,H,hd,hd), shift (B,1,D)}."""
    b_, _, d = x.shape
    heads, hd = rwkv_dims(cfg)
    r, k, v, g, logw = _time_mix_inputs(p, x, state["shift"])
    rh = r.reshape(b_, heads, hd).float()
    kh = k.reshape(b_, heads, hd).float()
    vh = v.reshape(b_, heads, hd).float()
    w = torch.exp(logw[:, 0].reshape(b_, heads, hd))
    s_prev = state["wkv"]
    y = torch.einsum("bhd,bhde->bhe", rh, s_prev) + \
        torch.einsum("bhd,hd,bhd,bhe->bhe", rh, p.u, kh, vh)
    s_new = s_prev * w[..., None] + torch.einsum("bhd,bhe->bhde", kh, vh)
    yv = _group_norm_gate(p, y, g, cfg, b_, 1, d)
    out = yv.to(x.dtype) @ p.wo
    return out, {"wkv": s_new, "shift": x}


def rwkv6_channel_mix(p: RWKV6, x: torch.Tensor, state=None,
                      return_state: bool = False):
    b_, s, d = x.shape
    last = torch.zeros((b_, 1, d), dtype=x.dtype, device=x.device) \
        if state is None else state
    xs = _token_shift(x, last)
    mix = p.cmix[:, None, None, :]
    fk = x * mix[0].to(x.dtype) + xs * (1 - mix[0]).to(x.dtype)
    fr = x * mix[1].to(x.dtype) + xs * (1 - mix[1]).to(x.dtype)
    kk = torch.square(F.relu(fk @ p.ck))
    out = torch.sigmoid((fr @ p.cr).float()).to(x.dtype) * (kk @ p.cv)
    if return_state:
        return out, x[:, -1:, :]
    return out
