"""Hand-written Hopper kernels for the QbS hot spots, with their plain
PyTorch versions and the dispatch seam (``ops``).

* ``minplus``              — tropical product behind ``d_top_only``
                             (``csrc/minplus.cu``)
* ``sketch_batch``         — d_top and the whole sketch of a query batch in
                             one launch (``csrc/sketch_batch.cu``)
* ``bitmap_expand_packed`` — the hub-hub block expansion over bit-packed
                             words (``csrc/bitmap_expand_packed.cu``)
* ``bitmap_expand``        — the same expansion over a dense bool block
                             (``csrc/bitmap_expand.cu``)
* ``hybrid_relay``         — the hybrid relay in one pass: the tail's CSR
                             pull and the hub block (``csrc/hybrid_relay.cu``)
* ``side_attach``          — one side of the recover search's attach:
                             certificate, closure steps and edge pass over
                             row-packed words (``csrc/side_attach.cu``)
* ``sharded_attach``       — the sharded general lane's attach, every
                             landmark and both sides, per shard over its
                             in-edges and gathered word tables
                             (``csrc/sharded_attach.cu``)

Nothing is compiled at import; ``_build`` runs ``nvcc`` on first launch.
"""
from .ops import (
    LAUNCHES,
    bitmap_expand,
    bitmap_expand_packed,
    hybrid_relay,
    minplus,
    reset_launches,
    sharded_attach,
    side_attach,
    sketch_batch,
    sketch_d_top,
)

__all__ = ["LAUNCHES", "bitmap_expand", "bitmap_expand_packed", "hybrid_relay",
           "minplus", "reset_launches", "sharded_attach", "side_attach",
           "sketch_batch", "sketch_d_top"]
