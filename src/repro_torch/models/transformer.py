"""Model assembly for the architecture pool, in PyTorch.  Counterpart of
``repro.models.transformer``.

One LM module with per-family block modules:

  dense / moe       pre-norm GQA attention + SwiGLU MLP (or MoE)
  ssm (rwkv6)       time-mix + channel-mix
  hybrid (zamba2)   groups of Mamba2 layers + one *shared* attention block
                    applied after every group (weights reused, zamba2-style
                    concat(h, first-layer input) conditioning)
  audio / vlm       stub modality frontends (precomputed frame/patch
                    embeddings) feeding the dense stack; audio is
                    encoder-only (bidirectional, no decode path)

The reference stacks each layer's parameters along a leading axis and
runs ``lax.scan`` over them; here the blocks sit in an ``nn.ModuleList``
(hybrid: a list of groups, each a list of Mamba2 layers) and a Python loop
runs them.  The reference's ``params`` argument folds into the module:
``forward(model, batch)`` is ``forward(params, cfg, batch)``.

Three entry points per model, as in the reference: ``loss_fn`` (training,
differentiable end to end), ``prefill`` and ``decode_step`` (serving, under
``torch.inference_mode``).  ``cfg.remat_policy == "layer"`` recomputes each
block of the loop in backward (``torch.utils.checkpoint``), the reference's
``jax.checkpoint`` of each scan body.

Caches follow the reference's trees with each stacked axis a list: dense
``{"layers": [(k, v), ...]}``; ssm ``{"layers": [{"tm": {wkv, shift},
"cm": shift}, ...]}``; hybrid ``{"mamba": [[{ssm, conv}, ...], ...],
"attn": [(k, v), ...]}`` (plus ``x0_last``, which decode carries and does
not read).  ``decode_step`` writes the new KV position into the cache it is
given (in place) and returns it; the recurrent states come back as new
tensors.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.graph import resolve_device
from . import layers as L
from . import mamba2 as M2
from . import moe as MOE
from . import rwkv6 as R6
from .config import ModelConfig


def _maybe_remat(body, cfg):
    """Per-layer activation checkpointing: the block saves only its inputs;
    its activations are recomputed during backward.  (The forward draws no
    random numbers, so no RNG state is stashed for the recomputation.)"""
    if cfg.remat_policy == "layer":
        def remat(*args, **kwargs):
            return checkpoint(body, *args, use_reentrant=False,
                              preserve_rng_state=False, **kwargs)
        return remat
    return body


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

class DenseBlock(nn.Module):
    """Pre-norm attention + MLP (or MoE): ``ln1 attn ln2 mlp|moe``."""

    def __init__(self, cfg: ModelConfig, init: L.Init):
        super().__init__()
        self.ln1 = init.full((cfg.d_model,), 1.0, torch.float32)
        self.attn = L.Attention(cfg, init)
        self.ln2 = init.full((cfg.d_model,), 1.0, torch.float32)
        if cfg.moe_experts:
            self.moe = MOE.MoE(cfg, init)
        else:
            self.mlp = L.MLP(cfg, init)


def _ffn(p: DenseBlock, h, cfg):
    """The block's second half on the normed residual.  MoE is dropless on
    every serving call."""
    hn = L.rmsnorm(h, p.ln2, cfg.norm_eps)
    if cfg.moe_experts:
        out, _ = MOE.moe(p.moe, hn, cfg, dropless=True)
        return h + out
    return h + L.mlp(p.mlp, hn)


def _dense_block(p: DenseBlock, x, cfg, *, causal: bool, train: bool = False):
    """MoE routing is capacity-dropping only when ``train=True``; every
    serving entry point (eval forward, prefill, decode) is dropless so
    prefill+decode reproduces the full-sequence forward."""
    h = x + L.attention(p.attn, L.rmsnorm(x, p.ln1, cfg.norm_eps), cfg, causal=causal)
    if cfg.moe_experts:
        out, aux = MOE.moe(p.moe, L.rmsnorm(h, p.ln2, cfg.norm_eps), cfg,
                           dropless=not train)
        return h + out, aux
    return h + L.mlp(p.mlp, L.rmsnorm(h, p.ln2, cfg.norm_eps)), \
        torch.zeros((), dtype=torch.float32, device=x.device)


def _dense_block_prefill(p: DenseBlock, x, cfg):
    a, cache = L.attention_prefill(p.attn, L.rmsnorm(x, p.ln1, cfg.norm_eps), cfg)
    return _ffn(p, x + a, cfg), cache


def _dense_block_decode(p: DenseBlock, x, cache, cache_len, cfg):
    a, cache = L.attention_decode(p.attn, L.rmsnorm(x, p.ln1, cfg.norm_eps),
                                  cache, cache_len, cfg)
    return _ffn(p, x + a, cfg), cache


class RWKVBlock(nn.Module):
    """``ln1 tm ln2``: time-mix and channel-mix share ``tm``'s weights."""

    def __init__(self, cfg: ModelConfig, init: L.Init):
        super().__init__()
        self.ln1 = init.full((cfg.d_model,), 1.0, torch.float32)
        self.tm = R6.RWKV6(cfg, init)
        self.ln2 = init.full((cfg.d_model,), 1.0, torch.float32)


def _rwkv_block(p: RWKVBlock, x, cfg):
    h = x + R6.rwkv6_time_mix(p.tm, L.rmsnorm(x, p.ln1, cfg.norm_eps), cfg)
    return h + R6.rwkv6_channel_mix(p.tm, L.rmsnorm(h, p.ln2, cfg.norm_eps))


def _rwkv_block_prefill(p: RWKVBlock, x, cfg):
    tm_out, tm_state = R6.rwkv6_time_mix(
        p.tm, L.rmsnorm(x, p.ln1, cfg.norm_eps), cfg, return_state=True)
    h = x + tm_out
    cm_out, cm_state = R6.rwkv6_channel_mix(
        p.tm, L.rmsnorm(h, p.ln2, cfg.norm_eps), return_state=True)
    return h + cm_out, {"tm": tm_state, "cm": cm_state}


def _rwkv_block_decode(p: RWKVBlock, x, cache, cfg):
    tm_out, tm_state = R6.rwkv6_time_mix_decode(
        p.tm, L.rmsnorm(x, p.ln1, cfg.norm_eps), cfg, cache["tm"])
    h = x + tm_out
    cm_out, cm_state = R6.rwkv6_channel_mix(
        p.tm, L.rmsnorm(h, p.ln2, cfg.norm_eps), cache["cm"], return_state=True)
    return h + cm_out, {"tm": tm_state, "cm": cm_state}


def _mamba_layer(p: "MambaLayer", h, cfg):
    return h + M2.mamba2_chunked(p.mamba, L.rmsnorm(h, p.ln, cfg.norm_eps), cfg)


class MambaLayer(nn.Module):
    """``ln mamba``: one core layer of a hybrid group."""

    def __init__(self, cfg: ModelConfig, init: L.Init):
        super().__init__()
        self.ln = init.full((cfg.d_model,), 1.0, torch.float32)
        self.mamba = M2.Mamba2(cfg, init)


class SharedBlock(nn.Module):
    """The hybrid's one shared attention block, conditioned on
    concat(h, x_emb): ``in_proj block out_proj``."""

    def __init__(self, cfg: ModelConfig, init: L.Init):
        super().__init__()
        self.in_proj = init.dense(2 * cfg.d_model, cfg.d_model)
        self.block = DenseBlock(cfg, init)
        self.out_proj = init.dense(cfg.d_model, cfg.d_model)


def _shared_apply(sp: SharedBlock, h, x0, cfg, *, train: bool = False):
    z = torch.cat([h, x0], dim=-1) @ sp.in_proj
    z, _ = _dense_block(sp.block, z, cfg, causal=not cfg.encoder_only, train=train)
    return h + z @ sp.out_proj


def _shared_prefill(sp: SharedBlock, h, x0, cfg):
    z = torch.cat([h, x0], dim=-1) @ sp.in_proj
    z, cache = _dense_block_prefill(sp.block, z, cfg)
    return h + z @ sp.out_proj, cache


def _shared_decode(sp: SharedBlock, h, x0, cache, cache_len, cfg):
    z = torch.cat([h, x0], dim=-1) @ sp.in_proj
    z, cache = _dense_block_decode(sp.block, z, cache, cache_len, cfg)
    return h + z @ sp.out_proj, cache


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class LM(nn.Module):
    """Every family's LM: ``embed ln_f [head] [frontend] blocks [shared]``.

    ``forward``, ``prefill``, ``decode`` and ``init_decode_cache`` are the
    module functions below (``decode`` is ``decode_step``) with this module
    as the parameters, the entry points of the reference's ``Model``."""

    def __init__(self, cfg: ModelConfig, *, device, generator):
        super().__init__()
        self.cfg = cfg
        init = L.Init(cfg, device, generator)
        self.embed = init.normal((cfg.vocab_size, cfg.d_model), 0.02)
        self.ln_f = init.full((cfg.d_model,), 1.0, torch.float32)
        if not cfg.tie_embeddings:
            self.head = init.dense(cfg.d_model, cfg.vocab_size)
        if cfg.frontend != "none":
            self.frontend = init.dense(cfg.frontend_dim, cfg.d_model)
        if cfg.family == "ssm":
            self.blocks = nn.ModuleList(RWKVBlock(cfg, init)
                                        for _ in range(cfg.n_layers))
        elif cfg.family == "hybrid":
            n_groups = cfg.n_layers // cfg.hybrid_period
            self.blocks = nn.ModuleList(
                nn.ModuleList(MambaLayer(cfg, init) for _ in range(cfg.hybrid_period))
                for _ in range(n_groups))
            self.shared = SharedBlock(cfg, init)
        else:  # dense / moe / audio / vlm
            self.blocks = nn.ModuleList(DenseBlock(cfg, init)
                                        for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, batch: dict, *, train: bool = False):
        return forward(self, batch, train=train)

    def loss(self, batch: dict):
        return loss_fn(self, batch)

    def prefill(self, batch: dict):
        return prefill(self, batch)

    def decode(self, cache, cache_len, tokens):
        return decode_step(self, cache, cache_len, tokens)

    def init_decode_cache(self, batch_size: int, max_seq: int, *,
                          kv_quant: bool = False):
        return init_decode_cache(self.cfg, batch_size, max_seq,
                                 kv_quant=kv_quant, device=self.device)


def init_params(cfg: ModelConfig, *, device=None,
                generator: torch.Generator | None = None) -> LM:
    """A fresh ``LM`` on ``device`` with weights drawn from ``generator``
    (seed 0 on ``device`` when none is given)."""
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    return LM(cfg, device=dev, generator=generator)


def _tokens(model: LM, t) -> torch.Tensor:
    return torch.as_tensor(t, device=model.device).long()


def _embed_inputs(model: LM, batch: dict) -> torch.Tensor:
    cfg = model.cfg
    dt = L.dtype_of(cfg.dtype)
    if cfg.frontend == "audio_frames":
        feats = torch.as_tensor(batch["features"], device=model.device)
        return feats.to(dt) @ model.frontend
    te = model.embed[_tokens(model, batch["tokens"])]
    if cfg.frontend == "vision_patches":
        pe = torch.as_tensor(batch["patches"], device=model.device).to(dt) \
            @ model.frontend
        return torch.cat([pe, te], dim=1)
    return te


def _unembed(model: LM, h):
    h = L.rmsnorm(h, model.ln_f, model.cfg.norm_eps)
    w = model.embed.T if model.cfg.tie_embeddings else model.head
    return (h @ w).float()


def forward(model: LM, batch: dict, *, train: bool = False):
    """Returns (logits (B, S, V) f32, aux_loss).  ``train`` selects the MoE
    dispatch mode (capacity-dropping vs dropless); the default is the
    inference semantics that prefill+decode reproduces."""
    cfg = model.cfg
    causal = not cfg.encoder_only
    x = _embed_inputs(model, batch)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)

    if cfg.family == "ssm":
        body = _maybe_remat(_rwkv_block, cfg)
        h = x
        for blk in model.blocks:
            h = body(blk, h, cfg)
        return _unembed(model, h), zero

    if cfg.family == "hybrid":
        inner = _maybe_remat(_mamba_layer, cfg)
        shared = _maybe_remat(_shared_apply, cfg)
        h = x
        for grp in model.blocks:
            for blk in grp:
                h = inner(blk, h, cfg)
            h = shared(model.shared, h, x, cfg, train=train)
        return _unembed(model, h), zero

    body = _maybe_remat(_dense_block, cfg)
    h, aux = x, zero
    for blk in model.blocks:
        h, a = body(blk, h, cfg, causal=causal, train=train)
        aux = aux + a
    return _unembed(model, h), aux / cfg.n_layers


def loss_fn(model: LM, batch: dict):
    """Next-token (or, encoder-only, masked-target) cross-entropy:
    ``(loss + 0.01 * aux, {"nll": loss, "aux": aux})``.  The vlm family's
    patch prefix is dropped before the shift; an optional ``loss_mask``
    weighs the targets."""
    cfg = model.cfg
    logits, aux = forward(model, batch, train=True)
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = torch.as_tensor(mask, device=model.device).float()
    if cfg.encoder_only:
        targets = _tokens(model, batch["targets"])
        lp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(lp, -1, targets[..., None])[..., 0]
    else:
        tokens = _tokens(model, batch["tokens"])
        if cfg.frontend == "vision_patches":
            logits = logits[:, batch["patches"].shape[1]:, :]
        lp = torch.log_softmax(logits[:, :-1], dim=-1)
        nll = -torch.gather(lp, -1, tokens[:, 1:, None])[..., 0]
        mask = torch.ones_like(nll) if mask is None else mask[:, 1:]
    loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss + 0.01 * aux, {"nll": loss, "aux": aux}


@torch.inference_mode()
def prefill(model: LM, batch: dict):
    """Run the full prompt; returns (last-position logits, cache)."""
    cfg = model.cfg
    if cfg.encoder_only:
        raise ValueError("encoder-only model has no autoregressive serving path")
    h = x = _embed_inputs(model, batch)

    if cfg.family == "ssm":
        caches = []
        for blk in model.blocks:
            h, st = _rwkv_block_prefill(blk, h, cfg)
            caches.append(st)
        cache = {"layers": caches, "x0_last": None}
    elif cfg.family == "hybrid":
        mamba_states, attn_caches = [], []
        for grp in model.blocks:
            sts = []
            for blk in grp:
                out, st = M2.mamba2_chunked(
                    blk.mamba, L.rmsnorm(h, blk.ln, cfg.norm_eps), cfg,
                    return_state=True)
                h = h + out
                sts.append(st)
            h, att = _shared_prefill(model.shared, h, x, cfg)
            mamba_states.append(sts)
            attn_caches.append(att)
        cache = {"mamba": mamba_states, "attn": attn_caches}
    else:
        caches = []
        for blk in model.blocks:
            h, c = _dense_block_prefill(blk, h, cfg)
            caches.append(c)
        cache = {"layers": caches}

    return _unembed(model, h[:, -1:, :]), cache


def init_decode_cache(cfg: ModelConfig, batch_size: int, max_seq: int, *,
                      kv_quant: bool = False, device=None):
    """Fresh caches sized for ``max_seq`` on ``device`` (the card unless
    named)."""
    dev = resolve_device(device)
    dt = L.dtype_of(cfg.dtype)
    f32 = torch.float32

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def kv():
        return L.make_kv_cache(batch_size, max_seq, cfg.n_kv_heads, cfg.hd, dt,
                               kv_quant, dev)

    if cfg.family == "ssm":
        heads, rhd = R6.rwkv_dims(cfg)
        return {"layers": [
            {"tm": {"wkv": zeros((batch_size, heads, rhd, rhd), f32),
                    "shift": zeros((batch_size, 1, cfg.d_model), dt)},
             "cm": zeros((batch_size, 1, cfg.d_model), dt)}
            for _ in range(cfg.n_layers)]}
    if cfg.family == "hybrid":
        d_inner, heads, mhd = M2.ssm_dims(cfg)
        n_groups = cfg.n_layers // cfg.hybrid_period
        mamba = [[{"ssm": zeros((batch_size, heads, mhd, cfg.ssm_state), f32),
                   "conv": zeros((batch_size, cfg.ssm_conv - 1, d_inner), dt)}
                  for _ in range(cfg.hybrid_period)] for _ in range(n_groups)]
        return {"mamba": mamba, "attn": [kv() for _ in range(n_groups)],
                "x0_last": zeros((batch_size, 1, cfg.d_model), dt)}
    return {"layers": [kv() for _ in range(cfg.n_layers)]}


@torch.inference_mode()
def decode_step(model: LM, cache, cache_len, tokens):
    """One token: tokens (B, 1) -> (logits (B, 1, V) f32, cache).
    ``cache_len`` is the number of filled positions (an int)."""
    cfg = model.cfg
    if cfg.encoder_only:
        raise ValueError("encoder-only model has no decode step")
    cache_len = int(cache_len)
    h = x = model.embed[_tokens(model, tokens)]

    if cfg.family == "ssm":
        new = []
        for blk, c in zip(model.blocks, cache["layers"]):
            h, c2 = _rwkv_block_decode(blk, h, c, cfg)
            new.append(c2)
        return _unembed(model, h), {"layers": new}

    if cfg.family == "hybrid":
        msts, acs = [], []
        for grp, mstates, acache in zip(model.blocks, cache["mamba"], cache["attn"]):
            sts = []
            for blk, st in zip(grp, mstates):
                out, st2 = M2.mamba2_decode(
                    blk.mamba, L.rmsnorm(h, blk.ln, cfg.norm_eps), cfg, st)
                h = h + out
                sts.append(st2)
            h, ac2 = _shared_decode(model.shared, h, x, acache, cache_len, cfg)
            msts.append(sts)
            acs.append(ac2)
        return _unembed(model, h), {"mamba": msts, "attn": acs,
                                    "x0_last": cache["x0_last"]}

    new = []
    for blk, c in zip(model.blocks, cache["layers"]):
        h, c2 = _dense_block_decode(blk, h, c, cache_len, cfg)
        new.append(c2)
    return _unembed(model, h), {"layers": new}
