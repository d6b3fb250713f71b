"""Model facade, sharding rules and meta-device input specs.  Counterpart
of ``repro.models.registry``.

``build_model(cfg)`` returns the family's ``LM`` module.  The reference's
``Model`` is a tuple of pure functions over a separate params tree; here
it is the ``nn.Module`` holding the parameters, with the same entry points
as methods (``cfg``, ``loss``, ``forward``, ``prefill``, ``decode``,
``init_decode_cache``); ``init`` is ``build_model`` itself.

``param_pspecs`` / ``batch_pspecs`` / ``cache_pspecs`` give the partition
specs (``distributed.sharding.P``) that the production-mesh dry run lays
the tensors out with: Megatron-style TP on ``model``, DP over the other
axes, EP for MoE experts, recurrent-state sharding for the SSM families.
They are the reference's rules, keyed by the port's names: a parameter
spec by its ``named_parameters()`` name, a cache spec at the same place of
the port's cache tree.  The reference stacks each layer's leaves along a
leading axis that its specs leave replicated; the port holds the layers as
list entries, so that axis is dropped from every spec.  ``input_specs``
returns meta-device tensors (the reference's ``ShapeDtypeStruct``s): they
carry shapes and dtypes and allocate nothing.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from ..distributed.sharding import P, path_keys, tree_map
from . import transformer as T
from .config import ModelConfig, ShapeCell

N_VLM_PATCHES = 256  # static patch-prefix length for the [vlm] stub frontend

Model = T.LM


def build_model(cfg: ModelConfig, *, device=None,
                generator: torch.Generator | None = None) -> Model:
    """The ``LM`` for ``cfg`` on ``device`` (the CUDA card unless named; the
    meta device allocates nothing), its weights drawn from ``generator``
    with the reference's distributions (seed 0 when none is given)."""
    return T.init_params(cfg, device=device, generator=generator)


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

_COL = {"wq", "wk", "wv", "wg", "wu", "ck", "cr", "in_proj", "head",
        "frontend", "conv_w", "wr"}
_ROW = {"wo", "wd", "cv", "out_proj"}
_BIAS_TP = {"bq", "bk", "bv"}


def _leaf_name(path) -> str:
    keys = path_keys(path)
    return keys[-1] if keys else ""


def param_pspecs(cfg: ModelConfig, params) -> dict[str, P]:
    """``{name: P}`` for ``params`` (the model, or ``{name: tensor}`` by
    ``named_parameters()`` names): TP on ``model``; MoE expert tensors
    expert-sharded (EP == the TP axis)."""
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())

    def rule(path, leaf):
        name = _leaf_name(path)
        nd = leaf.dim()
        if name == "embed":
            return P("model", None)
        if "moe" in path_keys(path) and name in {"wg", "wu", "wd"}:
            return P(*([None] * (nd - 3) + ["model", None, None]))
        if name in _COL:
            return P(*([None] * (nd - 2) + [None, "model"]))
        if name in _ROW:
            return P(*([None] * (nd - 2) + ["model", None]))
        if name in _BIAS_TP:
            return P(*([None] * (nd - 1) + ["model"]))
        return P(*([None] * nd))

    return tree_map(rule, params)


def row_parallel(name: str) -> bool:
    """Whether ``param_pspecs`` cuts this parameter's input dimension over
    ``model`` (before ``sanitize_pspecs``): its matmul's output is a partial
    sum on each model shard."""
    keys = path_keys((name,))
    return bool(keys) and keys[-1] in _ROW and "moe" not in keys


def batch_pspecs(cfg: ModelConfig, batch, dp_axes) -> Any:
    def rule(path, leaf):
        return P(*([dp_axes] + [None] * (leaf.dim() - 1)))

    return tree_map(rule, batch)


def cache_pspecs(cfg: ModelConfig, cache, dp_axes) -> Any:
    """KV caches: batch on DP, head_dim on 'model' (always divisible, unlike
    kv-head counts e.g. qwen32b kv=40 on TP16); SSM/RWKV states: heads on
    'model'."""

    def rule(path, leaf):
        # classify by the trailing 3/4 dims, as the reference does under
        # its layer-stack dims
        name = _leaf_name(path)
        nd = leaf.dim()
        if name in {"shift", "cm", "conv"}:              # (B, k, D) states
            return P(*([None] * (nd - 3) + [dp_axes, None, "model"]))
        if nd >= 4 and name in {"wkv", "ssm"}:          # (B, H, hd, {hd|N})
            return P(*([None] * (nd - 4) + [dp_axes, "model", None, None]))
        if nd >= 4 and name == "scale":                  # int8 KV scales (B,S,Hkv,1)
            return P(*([None] * (nd - 4) + [dp_axes, None, None, None]))
        if nd >= 4:                                      # KV (B, S, Hkv, hd) / int8 q
            return P(*([None] * (nd - 4) + [dp_axes, None, None, "model"]))
        if nd >= 3:                                      # (B, 1, D) states
            return P(*([None] * (nd - 3) + [dp_axes, None, "model"]))
        return P(*([dp_axes] + [None] * (nd - 1)))

    return tree_map(rule, cache)


def sanitize_pspecs(spec_tree, shape_tree, axis_sizes: dict[str, int]):
    """Drop mesh axes from any dimension they don't divide (e.g. hubert's
    vocab=504 on a 16-way model axis) — the leaf stays sharded on the other
    dims instead of failing at lowering."""

    def fix(_, spec, leaf):
        out = []
        for i, d in enumerate(spec):
            if d is None:
                out.append(None)
                continue
            prod = 1
            for a in ((d,) if isinstance(d, str) else tuple(d)):
                prod *= axis_sizes.get(a, 1)
            out.append(d if leaf.shape[i] % prod == 0 else None)
        return P(*out)

    return tree_map(fix, spec_tree, shape_tree)


# ---------------------------------------------------------------------------
# input specs (meta-device stand-ins, no allocation)
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeCell, *, kv_quant: bool = False) -> dict:
    """The step's inputs as meta tensors: ``{"batch": ...}`` for train and
    prefill; ``{"cache", "cache_len", "tokens"}`` for decode, the cache from
    ``init_decode_cache(..., device="meta")``."""
    b, s = shape.global_batch, shape.seq_len

    def sds(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    if shape.kind in ("train", "prefill"):
        if cfg.frontend == "audio_frames":   # prefill: the encoder's forward
            return {"batch": {
                "features": sds((b, s, cfg.frontend_dim), torch.float32),
                "targets": sds((b, s), torch.int32),
                "loss_mask": sds((b, s), torch.bool),
            }}
        if cfg.frontend == "vision_patches":
            return {"batch": {
                "patches": sds((b, N_VLM_PATCHES, cfg.frontend_dim), torch.float32),
                "tokens": sds((b, s - N_VLM_PATCHES), torch.int32),
            }}
        return {"batch": {"tokens": sds((b, s), torch.int32)}}

    # decode: one new token against a seq_len cache
    return {
        "cache": T.init_decode_cache(cfg, b, s, kv_quant=kv_quant, device="meta"),
        "cache_len": sds((), torch.int32),
        "tokens": sds((b, 1), torch.int32),
    }
