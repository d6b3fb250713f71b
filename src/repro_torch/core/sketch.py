"""Algorithm 3 (sketch computation), batched over queries.
Counterpart of ``repro.core.sketch``.

A sketch for SPG(u, v) is the set of landmark paths attaining

    d_top(u,v) = min_{r,r'} ( delta_ur + d_M(r, r') + delta_r'v )     (Eq. 3)

d_top goes through ``kernels.ops.sketch_d_top``, two chained min-plus
contractions: the hand-written ``minplus`` kernel on the card (what the
reference does with ``use_pallas=True``), its plain version on the CPU.
The structural part (attaining pairs, meta edges on their meta shortest
paths) stays as masked dense ops over R^2 / R^4, tiny at |R| = 20.
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


def _budget(side_land: torch.Tensor) -> torch.Tensor:
    b = torch.where(side_land < INF, side_land - 1, -1).amax(dim=1)
    return torch.clamp(b, min=0).to(torch.int32)


def compute_sketch_batch(lu: torch.Tensor, lv: torch.Tensor,
                         meta_w: torch.Tensor,
                         meta_dist: torch.Tensor) -> SketchBatch:
    """Sketches for rows ``lu``/``lv`` ``(B, R)``, packed or int32."""
    lu = widen_dist(lu)
    lv = widen_dist(lv)
    meta_w = widen_dist(meta_w)
    meta_dist = widen_dist(meta_dist)

    # pi[b, r, r'] = delta_ur + d_M(r,r') + delta_r'v  (clamped to INF)
    pi = torch.clamp(lu[:, :, None] + meta_dist[None, :, :] + lv[:, None, :],
                     max=INF)
    # Eq. 3 on the min-plus kernel (min is monotone, so clamping after the
    # reduction matches the clamped-pi reduction)
    d_top = torch.clamp(ops.sketch_d_top(lu.contiguous(), lv,
                                         meta_dist.contiguous()), max=INF)
    have = d_top < INF
    att = (pi == d_top[:, None, None]) & have[:, None, None]   # attaining pairs

    du_land = torch.where(att.any(dim=2), lu, INF)
    dv_land = torch.where(att.any(dim=1), lv, INF)

    # meta edge (i, j) is in the sketch iff it lies on a shortest meta path
    # between some attaining pair (r, r'):
    #   d_M(r,i) + w(i,j) + d_M(j,r') == d_M(r,r')
    cost = (meta_dist[:, :, None, None] + meta_w[None, :, :, None]
            + meta_dist.T[None, None, :, :])                    # (R, i, j, R')
    on_path = (cost == meta_dist[:, None, None, :]) \
        & (meta_w < INF)[None, :, :, None]
    # meta_edge[b,i,j] = any_{r,r'} att[b,r,r'] & on_path[r,i,j,r'] as a float
    # count (at most R^2, exact in f32; CUDA has no integer einsum)
    meta_edge = torch.einsum("brs,rijs->bij", att.to(torch.float32),
                             on_path.to(torch.float32)) > 0.5

    return SketchBatch(d_top=d_top.to(torch.int32),
                       du_land=du_land.to(torch.int32),
                       dv_land=dv_land.to(torch.int32), meta_edge=meta_edge,
                       d_star_u=_budget(du_land), d_star_v=_budget(dv_land))


def d_top_only(lu: torch.Tensor, lv: torch.Tensor, meta_dist: torch.Tensor,
               minplus=None) -> torch.Tensor:
    """Just the bound d_top: two chained min-plus contractions (``minplus``
    defaults to ``kernels.ops.minplus``), packed or int32 inputs."""
    minplus = ops.minplus if minplus is None else minplus
    t = minplus(widen_dist(lu).contiguous(), widen_dist(meta_dist).contiguous())
    return torch.clamp((t + widen_dist(lv)).amin(dim=1), max=INF)
