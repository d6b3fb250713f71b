"""Serving steps: the QbS shortest-path-graph query pipeline and the LM
prefill/decode units.  Counterpart of ``repro.serving.serve_step``.

**SPG serving** (``make_spg_serve_step`` / ``serve_spg_batch``): the
general lane of a built ``QbSIndex`` (label gather -> the fused
``sketch_batch`` kernel on the card -> batched guided search, every relay
one ``hybrid_relay`` call on the hybrid backend -> edge-mask
symmetrization) and the whole planner/service stack for arbitrary
batches, as ``QbSIndex.query_batch`` runs it.

**LM serving**: prefill and single-token decode, and a batched greedy
decode driver.  The reference passes a params tree to each step; here the
parameters live in the model module, so the steps take the model and no
params argument.  Every step runs under ``torch.inference_mode()``.  KV
caches are bf16-layout or int8 with per-position scales
(``models.layers``).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..models.layers import _quant
from ..models.registry import Model
from ..models.transformer import decode_step as _decode_step
from ..models.transformer import forward, init_decode_cache, prefill


# ---------------------------------------------------------------------------
# QbS shortest-path-graph serving
# ---------------------------------------------------------------------------


def make_spg_serve_step(index) -> Callable:
    """Return the SPG serving step of a ``QbSIndex``: int32 query tensors
    ``(us, vs)`` of shape ``(B,)`` on the index's device to device tensors
    ``(dist (B,) int32, edge_mask (B, E) bool)``, the mask already
    symmetrized through the reverse-edge map.

    It reads the index's packed uint8/uint16 label tables, widened inside
    the ``sketch_batch`` kernel.  Landmark-endpoint queries are *not*
    handled here (their lanes are garbage): the planner routes them to
    ``QbSIndex.landmark_pair_step`` / ``landmark_onesided_step``.  A
    vertex-sharded index (``core.sharded.ShardedIndex``) satisfies the same
    contract over its shards.
    """
    return index.serve_step


def serve_spg_batch(index, us, vs) -> tuple[np.ndarray, np.ndarray]:
    """Answer an arbitrary-size query batch through the planner/service
    stack (lane routing, dedup, chunked dispatch).  Returns
    ``(dist (N,) int32, edge_mask (N, E) bool)`` on the host."""
    return index.query_batch_arrays(us, vs)


# ---------------------------------------------------------------------------
# LM serving
# ---------------------------------------------------------------------------


def make_prefill_step(model: Model):
    """``prefill_step(batch) -> (logits, cache)``; for an encoder-only model
    the full forward pass, with no cache."""
    @torch.inference_mode()
    def prefill_step(batch):
        if model.cfg.encoder_only:
            logits, _ = forward(model, batch)
            return logits, None
        return prefill(model, batch)

    return prefill_step


def make_decode_step(model: Model):
    """``decode_step(cache, cache_len, tokens) -> (logits, cache)``."""
    def decode_step(cache, cache_len, tokens):
        return _decode_step(model, cache, cache_len, tokens)

    return decode_step


def _write_prefix(buf, x: torch.Tensor, s: int) -> None:
    """Write the prompt's K or V into positions ``0..s-1`` of a fresh decode
    buffer: cast for the bf16 layout, quantised for int8 (``_quant``, as
    decode writes each later position)."""
    if isinstance(buf, dict):
        q = _quant(x)
        buf["q"][:, :s] = q["q"]
        buf["scale"][:, :s] = q["scale"]
    else:
        buf[:, :s] = x.to(buf.dtype)


@torch.inference_mode()
def greedy_generate(model: Model, prompt_tokens, n_new: int, *,
                    kv_quant: bool = False, return_logits: bool = False):
    """Prefill the prompt then decode ``n_new`` tokens greedily; returns the
    new tokens ``(B, n_new)`` int32 on the model's device (and, with
    ``return_logits``, each step's f32 logits ``(B, n_new, V)``).

    One deliberate divergence from the reference: with ``kv_quant`` the
    hybrid family's shared-attention cache gets the prompt's K/V quantised
    into it, as the dense family's does.  The reference leaves that int8
    cache empty, so its first decoded token attends to zero keys."""
    cfg = model.cfg
    toks = torch.as_tensor(prompt_tokens, device=model.device)
    b, s = toks.shape
    logits, pre = prefill(model, {"tokens": toks})
    if cfg.family == "ssm":
        cache = pre
    else:
        cache = init_decode_cache(cfg, b, s + n_new, kv_quant=kv_quant,
                                  device=model.device)
        key = "attn" if cfg.family == "hybrid" else "layers"
        for (k_buf, v_buf), (k_pre, v_pre) in zip(cache[key], pre[key]):
            _write_prefix(k_buf, k_pre, s)
            _write_prefix(v_buf, v_pre, s)
        if cfg.family == "hybrid":
            cache["mamba"] = pre["mamba"]

    steps = [logits[:, -1, :]]
    out = [steps[-1].argmax(dim=-1).to(torch.int32)]
    for i in range(n_new - 1):
        logits, cache = _decode_step(model, cache, s + i, out[-1][:, None])
        steps.append(logits[:, 0, :])
        out.append(steps[-1].argmax(dim=-1).to(torch.int32))
    tokens = torch.stack(out, dim=1)
    return (tokens, torch.stack(steps, dim=1)) if return_logits else tokens
