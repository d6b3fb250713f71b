"""Training in PyTorch: AdamW, the warmup+cosine schedule and the train
step.  Counterpart of ``repro.training``."""
from .optimizer import Optimizer, adamw, clip_by_global_norm, global_norm, warmup_cosine
from .train_step import compress_bf16, make_train_step

__all__ = ["Optimizer", "adamw", "clip_by_global_norm", "compress_bf16",
           "global_norm", "make_train_step", "warmup_cosine"]
