"""hubert-xlarge [audio] — encoder-only, w2v2 arch [arXiv:2106.07447;
unverified].  48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (cluster
targets).  Modality frontend is a stub: ``input_specs()`` provides
precomputed frame embeddings (frontend_dim=512)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    encoder_only=True,
    frontend="audio_frames",
    frontend_dim=512,
)
