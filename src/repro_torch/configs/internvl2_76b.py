"""internvl2-76b [vlm] — InternViT + Llama3-70B-style LM backbone
[arXiv:2404.16821; unverified].  80L d_model=8192 64H (kv=8) d_ff=28672
vocab=128256.  Vision frontend is a stub: ``input_specs()`` provides
precomputed patch embeddings (256 patches, frontend_dim=1024)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    frontend="vision_patches",
    frontend_dim=1024,
)
