"""Model facade: ``build_model(cfg)`` returns the family's ``LM`` module.
Counterpart of ``repro.models.registry``.

The reference's ``Model`` is a tuple of pure functions over a separate
params tree (``init``, ``loss``, ``forward``, ``prefill``, ``decode``,
``init_decode_cache``); here it is the ``nn.Module`` holding the
parameters, with the same entry points as methods (``cfg``, ``loss``,
``forward``, ``prefill``, ``decode``, ``init_decode_cache``); ``init`` is
``build_model`` itself.  The partition-spec rules (``param_pspecs``,
``batch_pspecs``, ``cache_pspecs``, ``sanitize_pspecs``) and
``input_specs`` belong to the production-mesh dry run, which is not ported
yet.
"""
from __future__ import annotations

import torch

from . import transformer as T
from .config import ModelConfig

N_VLM_PATCHES = 256  # static patch-prefix length for the [vlm] stub frontend

Model = T.LM


def build_model(cfg: ModelConfig, *, device=None,
                generator: torch.Generator | None = None) -> Model:
    """The ``LM`` for ``cfg`` on ``device`` (the CUDA card unless named; the
    meta device allocates nothing), its weights drawn from ``generator``
    with the reference's distributions (seed 0 when none is given)."""
    return T.init_params(cfg, device=device, generator=generator)
