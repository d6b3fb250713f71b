"""zamba2-2.7b [hybrid] — Mamba2 blocks + shared attention block
[arXiv:2411.15242; hf].  54L d_model=2560 32H (kv=32) d_ff=10240
vocab=32000, ssm_state=64; shared full block every 6 Mamba2 layers
(9 applications of one weight set), conditioned on concat(h, x_emb)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_conv=4,
    hybrid_period=6,
)
