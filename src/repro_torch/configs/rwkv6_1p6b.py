"""rwkv6-1.6b "Finch" [ssm] — attention-free, data-dependent decay
[arXiv:2404.05892; unverified].  24L d_model=2048 d_ff=7168 vocab=65536."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,        # unused (attention-free); kept for config uniformity
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    rwkv_head_dim=64,
)
