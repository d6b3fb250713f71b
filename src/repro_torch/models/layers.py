"""Shared transformer primitives in PyTorch: RMSNorm, RoPE, GQA attention
(train / prefill / single-step decode with a KV cache, bf16 or int8), the
SwiGLU MLP and the parameter initialiser.  Counterpart of
``repro.models.layers``.

The reference keeps parameters in dict pytrees; here each block is an
``nn.Module`` whose attributes carry the reference's key names (``wq``,
``wk``, ... with the same ``(d_in, d_out)`` layout, so ``x @ p.wq`` is the
reference's ``x @ p["wq"]``), and the functions below take that module as
``p``.  Attention is the reference's einsum/softmax arithmetic in torch
ops (no fused attention kernel), with the same f32 casts, so both packages
compute the same thing.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

class Init:
    """Draws parameters with the reference's distributions: dense weights
    normal x ``d_in ** -0.5`` (drawn in f32, then cast), embeddings normal x
    0.02, norm gains ones, biases zeros.  Every draw comes from one explicit
    ``torch.Generator`` on ``device``, so a seed fixes the weights; the values
    differ from JAX's PRNG.  On the meta device nothing is drawn (the
    converter's path, which fills every parameter afterwards)."""

    def __init__(self, cfg, device, generator: torch.Generator | None):
        self.device = torch.device(device)
        self.generator = generator
        self.dtype = dtype_of(cfg.dtype)

    def _f32(self, shape, draw) -> torch.Tensor:
        t = torch.empty(shape, dtype=torch.float32, device=self.device)
        if self.device.type != "meta":
            draw(t)
        return t

    def normal(self, shape, scale: float, dtype=None) -> nn.Parameter:
        t = self._f32(shape, lambda t: t.normal_(generator=self.generator))
        return nn.Parameter((t * scale).to(dtype or self.dtype))

    def dense(self, d_in: int, d_out: int, dtype=None,
              scale: float | None = None) -> nn.Parameter:
        return self.normal((d_in, d_out), d_in ** -0.5 if scale is None else scale,
                           dtype)

    def uniform(self, shape, dtype) -> nn.Parameter:
        t = self._f32(shape, lambda t: t.uniform_(generator=self.generator))
        return nn.Parameter(t.to(dtype))

    def full(self, shape, value: float, dtype=None) -> nn.Parameter:
        return nn.Parameter(torch.full(shape, value, dtype=dtype or self.dtype,
                                       device=self.device))


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, gain: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    h = x.float()
    h = h * torch.rsqrt((h * h).mean(-1, keepdim=True) + eps)
    return (h * gain.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    ang = positions[..., :, None, None].float() * freqs      # (..., S, 1, hd/2)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """GQA attention weights (``wq wk wv wo``, ``bq bk bv`` with QKV bias)."""

    def __init__(self, cfg, init: Init):
        super().__init__()
        hd, d = cfg.hd, cfg.d_model
        self.wq = init.dense(d, cfg.n_heads * hd)
        self.wk = init.dense(d, cfg.n_kv_heads * hd)
        self.wv = init.dense(d, cfg.n_kv_heads * hd)
        self.wo = init.dense(cfg.n_heads * hd, d)
        if cfg.qkv_bias:
            self.bq = init.full((cfg.n_heads * hd,), 0.0)
            self.bk = init.full((cfg.n_kv_heads * hd,), 0.0)
            self.bv = init.full((cfg.n_kv_heads * hd,), 0.0)


def _qkv(p: Attention, x: torch.Tensor, cfg):
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if cfg.qkv_bias:
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    b, s, _ = x.shape
    hd = cfg.hd
    return (q.reshape(b, s, cfg.n_heads, hd),
            k.reshape(b, s, cfg.n_kv_heads, hd),
            v.reshape(b, s, cfg.n_kv_heads, hd))


def _sdpa(q, k, v, causal: bool, q_offset: int = 0):
    """q: (B, Sq, H, hd); k/v: (B, Sk, Hkv, hd) — GQA via head grouping."""
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    qg = q.reshape(b, sq, hkv, group, hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) / (hd ** 0.5)
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + q_offset
        ki = torch.arange(sk, device=q.device)[None, :]
        logits = torch.where((qi >= ki)[None, None, None], logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def _sdpa_chunked(q, k, v, causal: bool, chunk: int):
    """Online-softmax attention over KV chunks (flash-style memory profile:
    logits tiles are (Sq, chunk) instead of (Sq, Sk)).  f32 accumulators;
    the reference's ``lax.scan`` over chunks is a Python loop."""
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    chunk = min(chunk, sk)
    n_chunks = sk // chunk
    assert n_chunks * chunk == sk, (sk, chunk)
    qg = q.reshape(b, sq, hkv, group, hd).float()
    scale = hd ** -0.5
    qi = torch.arange(sq, device=q.device)
    acc = torch.zeros((b, hkv, group, sq, hd), dtype=torch.float32, device=q.device)
    m = torch.full((b, hkv, group, sq), -1e30, dtype=torch.float32, device=q.device)
    l_ = torch.zeros((b, hkv, group, sq), dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        k_c = k[:, c * chunk:(c + 1) * chunk].float()
        v_c = v[:, c * chunk:(c + 1) * chunk].float()
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_c) * scale
        if causal:
            ki = c * chunk + torch.arange(chunk, device=q.device)
            logits = torch.where((qi[:, None] >= ki[None, :])[None, None, None],
                                 logits, -1e30)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p_ = torch.exp(logits - m_new[..., None])
        l_ = l_ * alpha + p_.sum(dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p_, v_c)
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l_[..., None], min=1e-30)
    out = out.reshape(b, h, sq, hd).movedim(1, 2)
    return out.to(q.dtype)


def attention(p: Attention, x: torch.Tensor, cfg, *, causal: bool) -> torch.Tensor:
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    pos = torch.arange(s, device=x.device)[None, :]
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    if cfg.attn_impl == "chunked" and s > cfg.attn_chunk:
        out = _sdpa_chunked(q, k, v, causal, cfg.attn_chunk)
    else:
        out = _sdpa(q, k, v, causal)
    return out.reshape(b, s, -1) @ p.wo


def attention_prefill(p: Attention, x: torch.Tensor, cfg):
    """Returns (out, cache) where cache = (k, v) laid out (B, S, Hkv, hd)."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    pos = torch.arange(s, device=x.device)[None, :]
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    out = _sdpa(q, k, v, causal=True)
    return out.reshape(b, s, -1) @ p.wo, (k, v)


def attention_decode(p: Attention, x: torch.Tensor, cache, cache_len: int, cfg):
    """One decoded token against a filled KV cache.

    x: (B, 1, D); cache: (k, v) each (B, S_max, Hkv, hd), or int8 dicts;
    cache_len: the number of valid cache positions.  The new position is
    written into ``cache`` in place (``_cache_append``)."""
    b = x.shape[0]
    cache_len = int(cache_len)
    q, k_new, v_new = _qkv(p, x, cfg)
    pos = torch.full((b, 1), cache_len, dtype=torch.int32, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k_new = apply_rope(k_new, pos, cfg.rope_theta)
    k_cache, v_cache = cache
    k_all, v_all = _cache_append(k_cache, v_cache, k_new, v_new, cache_len)

    kd = _dequant(k_all, k_new.dtype)
    vd = _dequant(v_all, v_new.dtype)
    sk = kd.shape[1]
    # mask out unwritten cache slots
    valid = torch.arange(sk, device=x.device)[None, :] <= cache_len
    _, sq, h, hd = q.shape
    hkv = kd.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), kd.float()) / (hd ** 0.5)
    logits = torch.where(valid[:, None, None, None, :], logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, vd.float())
    out = out.reshape(b, sq, h * hd).to(x.dtype)
    return out @ p.wo, (k_all, v_all)


# -- KV cache quantization ---------------------------------------------------

def make_kv_cache(b: int, s_max: int, hkv: int, hd: int, dtype, quantized: bool,
                  device):
    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    if quantized:
        return tuple({"q": zeros((b, s_max, hkv, hd), torch.int8),
                      "scale": zeros((b, s_max, hkv, 1), torch.float32)}
                     for _ in range(2))
    return zeros((b, s_max, hkv, hd), dtype), zeros((b, s_max, hkv, hd), dtype)


def _quant(x: torch.Tensor) -> dict:
    scale = x.float().abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-8
    # x / scale promotes to f32 as in the reference; round is half-to-even
    return {"q": torch.round(x / scale).to(torch.int8), "scale": scale}


def _dequant(c, dtype):
    if isinstance(c, dict):
        return (c["q"].float() * c["scale"]).to(dtype)
    return c


def _cache_append(k_cache, v_cache, k_new, v_new, cache_len: int):
    """Write the new positions at ``cache_len`` in place and return the
    caches.  The start clamps to ``S_max - len`` as the reference's
    ``dynamic_update_slice`` does."""
    s_max = (k_cache["q"] if isinstance(k_cache, dict) else k_cache).shape[1]
    n = k_new.shape[1]
    at = min(max(int(cache_len), 0), s_max - n)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        if isinstance(cache, dict):
            qd = _quant(new)
            cache["q"][:, at:at + n] = qd["q"]
            cache["scale"][:, at:at + n] = qd["scale"]
        else:
            cache[:, at:at + n] = new.to(cache.dtype)
    return k_cache, v_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """SwiGLU weights ``wg wu wd``."""

    def __init__(self, cfg, init: Init, d_ff: int | None = None):
        super().__init__()
        d_ff = d_ff or cfg.d_ff
        self.wg = init.dense(cfg.d_model, d_ff)
        self.wu = init.dense(cfg.d_model, d_ff)
        self.wd = init.dense(d_ff, cfg.d_model)


def mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p.wg) * (x @ p.wu)) @ p.wd
