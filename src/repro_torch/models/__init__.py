"""Architecture zoo in PyTorch: dense/MoE GQA transformers, Mamba2 SSD,
RWKV6, zamba2-style hybrid, encoder-only audio, VLM.  Counterpart of
``repro.models``: the training entry point (``loss_fn``) and the serving
half (forward, prefill, decode)."""
from .config import SHAPES, ModelConfig, ShapeCell, cell_applicable
from .registry import N_VLM_PATCHES, Model, build_model
from .transformer import (LM, decode_step, forward, init_decode_cache, loss_fn,
                          prefill)

__all__ = [
    "LM",
    "N_VLM_PATCHES",
    "SHAPES",
    "Model",
    "ModelConfig",
    "ShapeCell",
    "build_model",
    "cell_applicable",
    "decode_step",
    "forward",
    "init_decode_cache",
    "loss_fn",
    "prefill",
]
