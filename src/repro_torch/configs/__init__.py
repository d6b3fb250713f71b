"""Assigned architecture pool: exact public configs, looked up by name with
``get_config``.  Sources and verification tiers are recorded in each
module's docstring.  Copies of ``repro.configs`` (pure Python), so the port
never imports the JAX package; ``qbs_graphs`` holds the paper's graph
scales."""
from __future__ import annotations

from ..models.config import ModelConfig
from . import (
    dbrx_132b,
    deepseek_7b,
    hubert_xlarge,
    internvl2_76b,
    phi3_medium_14b,
    phi3p5_moe_42b,
    qwen1p5_32b,
    qwen1p5_4b,
    rwkv6_1p6b,
    zamba2_2p7b,
)

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        zamba2_2p7b, qwen1p5_4b, deepseek_7b, qwen1p5_32b, phi3_medium_14b,
        phi3p5_moe_42b, dbrx_132b, rwkv6_1p6b, hubert_xlarge, internvl2_76b,
    )
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch]
