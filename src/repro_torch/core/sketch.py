"""Algorithm 3 (sketch computation), batched over queries.
Counterpart of ``repro.core.sketch``.

A sketch for SPG(u, v) is the set of landmark paths attaining

    d_top(u,v) = min_{r,r'} ( delta_ur + d_M(r, r') + delta_r'v )     (Eq. 3)

``compute_sketch_batch`` is one ``kernels.ops.sketch_batch`` call: on the
card the fused ``sketch_batch`` kernel computes d_top (the min-plus
contraction the reference runs on its Pallas kernel with
``use_pallas=True``) and the whole sketch in one launch; on the CPU its
plain version (``kernels.ref.sketch_batch_ref``) does.  ``d_top_only``
keeps the two chained min-plus contractions on the ``minplus`` kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import ops
from .graph import INF
from .packing import widen_dist


class SketchBatch(NamedTuple):
    """Sketches S_uv for a batch of queries (Definition 4.5)."""

    d_top: torch.Tensor      # (B,) upper bound; INF when no landmark path exists
    du_land: torch.Tensor    # (B, R) sigma_S(u, r); INF = absent
    dv_land: torch.Tensor    # (B, R) sigma_S(v, r')
    meta_edge: torch.Tensor  # (B, R, R) bool: meta edge (i, j) in the sketch
    d_star_u: torch.Tensor   # (B,) per-side search budget (Eq. 4)
    d_star_v: torch.Tensor   # (B,)


def compute_sketch_batch(lu: torch.Tensor, lv: torch.Tensor,
                         meta_w: torch.Tensor,
                         meta_dist: torch.Tensor) -> SketchBatch:
    """Sketches for rows ``lu``/``lv`` ``(B, R)``, packed or int32."""
    return SketchBatch(*ops.sketch_batch(lu, lv, meta_w, meta_dist))


def d_top_only(lu: torch.Tensor, lv: torch.Tensor, meta_dist: torch.Tensor,
               minplus=None) -> torch.Tensor:
    """Just the bound d_top: two chained min-plus contractions (``minplus``
    defaults to ``kernels.ops.minplus``), packed or int32 inputs."""
    minplus = ops.minplus if minplus is None else minplus
    t = minplus(widen_dist(lu).contiguous(), widen_dist(meta_dist).contiguous())
    return torch.clamp((t + widen_dist(lv)).amin(dim=1), max=INF)
