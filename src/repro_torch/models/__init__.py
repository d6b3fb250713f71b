"""Architecture zoo in PyTorch: dense/MoE GQA transformers, Mamba2 SSD,
RWKV6, zamba2-style hybrid, encoder-only audio, VLM.  Counterpart of
``repro.models``: the training entry point (``loss_fn``), the serving
half (forward, prefill, decode) and the dry run's partition-spec rules."""
from .config import SHAPES, ModelConfig, ShapeCell, cell_applicable
from .registry import (N_VLM_PATCHES, Model, batch_pspecs, build_model,
                       cache_pspecs, input_specs, param_pspecs, sanitize_pspecs)
from .transformer import (LM, decode_step, forward, init_decode_cache, loss_fn,
                          prefill)

__all__ = [
    "LM",
    "N_VLM_PATCHES",
    "SHAPES",
    "Model",
    "ModelConfig",
    "ShapeCell",
    "batch_pspecs",
    "build_model",
    "cache_pspecs",
    "cell_applicable",
    "decode_step",
    "forward",
    "init_decode_cache",
    "input_specs",
    "loss_fn",
    "param_pspecs",
    "prefill",
    "sanitize_pspecs",
]
