"""Model configuration for the assigned architecture pool: a copy of
``repro.models.config`` (pure Python), so the port never imports the JAX
package.  Fields that only the training and sharding paths read
(``remat_policy``, ``act_spec``, ``moe_ep_anchor``, ``scan_unroll``) are kept
so one config means the same model in both packages."""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_capacity_factor: float = 1.25
    moe_dispatch: str = "onehot"   # onehot (GShard baseline) | sort (optimized)
    moe_group_size: int = 0        # tokens per dispatch group (0 = one global
                                   # group = naive GShard; 1024 = optimized)
    # Anchor MoE expert buffers to EP sharding (axis "model") so GSPMD lowers
    # the sort-dispatch scatter locally instead of replicating it.
    moe_ep_anchor: bool = False
    # Attention implementation: "naive" materializes (S, S) logits (baseline);
    # "chunked" = online-softmax over KV chunks (flash-style memory profile).
    attn_impl: str = "naive"
    attn_chunk: int = 512
    # "layer": jax.checkpoint each scan body — saves only per-layer inputs,
    # recomputes activations in backward.  "none" stashes everything.
    remat_policy: str = "none"
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_heads: int = 0           # 0 -> d_model * expand // 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    # hybrid (zamba2-style shared attention block)
    hybrid_period: int = 0       # apply shared attn block every k core layers
    # rwkv6
    rwkv_head_dim: int = 64
    # structure
    encoder_only: bool = False
    frontend: str = "none"       # none | audio_frames | vision_patches
    frontend_dim: int = 0        # stub modality embedding width
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # Fully unroll layer scans (dry-run depth probes: makes per-layer cost
    # visible to HloCostAnalysis, which visits a while-loop body only once).
    scan_unroll: bool = False
    # Per-block activation sharding anchor, e.g. (("pod","data"), None, None)
    # for Megatron-style DP-only activations or (("pod","data"), "model", None)
    # for sequence-parallel.  None = let GSPMD choose (baseline).
    act_spec: tuple | None = None

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """May run the long_500k decode shape (SSM/hybrid/linear-attn)."""
        return self.family in ("ssm", "hybrid")

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        base = dict(
            n_layers=2 if self.hybrid_period == 0 else 2 * self.hybrid_period,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=128,
            vocab_size=128,
            head_dim=16,
        )
        if self.moe_experts:
            base["moe_experts"] = 4
            base["moe_top_k"] = min(self.moe_top_k, 2)
        if self.ssm_state:
            base["ssm_state"] = 16
            base["ssm_heads"] = 4
        if self.frontend_dim:
            base["frontend_dim"] = 32
        base.update(overrides)
        return replace(self, **base)


@dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) cell of the assigned grid."""

    name: str              # train_4k | prefill_32k | decode_32k | long_500k
    kind: str              # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}


def cell_applicable(cfg: ModelConfig, shape: ShapeCell) -> tuple[bool, str]:
    """The brief's skip rules; reason recorded in EXPERIMENTS.md."""
    if cfg.encoder_only and shape.kind == "decode":
        return False, "encoder-only: no autoregressive decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: no sub-quadratic path at 500k"
    return True, ""
