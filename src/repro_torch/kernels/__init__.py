"""Hand-written Hopper kernels for the QbS hot spots, with their plain
PyTorch versions and the dispatch seam (``ops``).

* ``minplus``              — tropical product behind the sketch's d_top
                             (``csrc/minplus.cu``)
* ``bitmap_expand_packed`` — the hybrid relay's hub-hub block expansion
                             (``csrc/bitmap_expand_packed.cu``)
* ``bitmap_expand``        — the same expansion over a dense bool block
                             (``csrc/bitmap_expand.cu``)

Nothing is compiled at import; ``_build`` runs ``nvcc`` on first launch.
"""
from .ops import (
    LAUNCHES,
    bitmap_expand,
    bitmap_expand_packed,
    minplus,
    reset_launches,
    sketch_d_top,
)

__all__ = ["LAUNCHES", "bitmap_expand", "bitmap_expand_packed", "minplus",
           "reset_launches", "sketch_d_top"]
