"""The data pipeline (numpy; the batches move to the device in the train
loop).  Counterpart of ``repro.data``."""
from .pipeline import FileBackedLM, Prefetcher, SyntheticLM, SyntheticLMConfig

__all__ = ["FileBackedLM", "Prefetcher", "SyntheticLM", "SyntheticLMConfig"]
