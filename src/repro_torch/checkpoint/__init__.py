"""Checkpoint/restart for the port's trees of tensors.  Counterpart of
``repro.checkpoint``."""
from .checkpoint import latest_step, restore, save, save_async

__all__ = ["latest_step", "restore", "save", "save_async"]
