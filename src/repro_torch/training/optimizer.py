"""The optimizer stack in PyTorch: AdamW with decoupled weight decay,
global-norm clipping, the warmup+cosine schedule.  Counterpart of
``repro.training.optimizer``, computed as it computes: the moments are
float32 whatever the parameter dtype (bf16 parameters, f32 moments), the
bias corrections come from the int32 step cast to float32, and the schedule
is float32 tensor arithmetic.

The state is ``{"mu": {name: f32}, "nu": {name: f32}, "step": int32 scalar}``,
keyed by ``named_parameters()`` names.  ``update`` writes the parameters
and the state in place and never holds a float32 copy of the whole
gradient tree: the reference casts every gradient to f32 and then builds a
clipped copy, two extra trees that at 4 B parameters do not fit beside the
parameters, gradients and moments on an 80 GB card.  Here the global norm
is a sum of per-leaf float32 sums, and the update runs over groups of
flat pieces of the leaves, each group at most ``GROUP_ELEMS`` elements,
with ``torch._foreach_*`` ops, each step of the reference's formula one op
(elementwise, so the pieces change no value).  (``torch.optim.AdamW``
keeps its moments in the parameter dtype and orders decay and epsilon
differently.)
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

# elements per foreach group (a larger leaf is cut into flat pieces): the
# update's float32 temporaries hold about four groups' worth, 2 GiB
GROUP_ELEMS = 1 << 27


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1) -> Callable[[torch.Tensor], torch.Tensor]:
    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0, 1)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)
    return schedule


def _pieces(t: torch.Tensor) -> list[torch.Tensor]:
    """``t`` flattened and cut into views of at most ``GROUP_ELEMS``
    elements (writes through them reach ``t``; a non-contiguous ``t``
    raises)."""
    flat = t.view(-1)
    return [flat[i:i + GROUP_ELEMS] for i in range(0, flat.numel(), GROUP_ELEMS)]


def _sq_sum(g: torch.Tensor) -> torch.Tensor:
    """The float32 sum of squares of one leaf, taken piece by piece so no
    float32 copy of a large leaf is ever whole."""
    return sum(torch.sum(torch.square(p.to(torch.float32)))
               for p in _pieces(g.contiguous()))


def global_norm(tree: dict) -> torch.Tensor:
    """The float32 norm of every leaf of ``{name: tensor}``, as a sum of
    per-leaf float32 sums of squares."""
    return torch.sqrt(sum(_sq_sum(g) for g in tree.values()))


def clip_by_global_norm(tree: dict, max_norm: float) -> tuple[dict, torch.Tensor]:
    """``(tree scaled by min(1, max_norm / (norm + 1e-9)), norm)``: new
    tensors, the input untouched."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in tree.items()}, norm


def _groups(names: list[str], params: dict) -> list[list[tuple[str, int]]]:
    """``(name, piece index)`` pairs in groups of one parameter dtype and at
    most ``GROUP_ELEMS`` elements, in order."""
    groups, cur, n, dt = [], [], 0, None
    for name in names:
        p = params[name]
        for i, piece in enumerate(_pieces(p)):
            if cur and (p.dtype != dt or n + piece.numel() > GROUP_ELEMS):
                groups.append(cur)
                cur, n = [], 0
            cur.append((name, i))
            n += piece.numel()
            dt = p.dtype
    if cur:
        groups.append(cur)
    return groups


def adamw(
    lr: Callable | float,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float = 1.0,
) -> Optimizer:
    def lr_fn(step):
        if callable(lr):
            return lr(step)
        return torch.tensor(lr, dtype=torch.float32, device=step.device)

    def init(params: dict) -> dict:
        """Zero moments (float32) for ``{name: parameter}`` and step 0."""
        dev = next(iter(params.values())).device
        return {"mu": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                       for k, p in params.items()},
                "nu": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                       for k, p in params.items()},
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(grads: dict, state: dict, params: dict):
        """One AdamW step on ``{name: parameter}`` with ``{name: gradient}``
        (any float dtype), in place: returns ``(params, state, {"grad_norm",
        "lr"})`` with the same objects, every value a device tensor."""
        names = list(params)
        grads = {k: g.contiguous() for k, g in grads.items()}
        gnorm = global_norm(grads)
        scale = torch.clamp(clip_norm / (gnorm + 1e-9), max=1.0)
        step = state["step"] + 1
        lr_t = lr_fn(step)
        bc1 = 1 - b1 ** step.to(torch.float32)
        bc2 = 1 - b2 ** step.to(torch.float32)
        pieces = {key: {k: _pieces(tree[k]) for k in names}
                  for key, tree in (("p", params), ("g", grads), ("m", state["mu"]),
                                    ("v", state["nu"]))}
        for group in _groups(names, params):
            p, g, m, v = ([pieces[key][k][i] for k, i in group] for key in "pgmv")
            # the clipped f32 gradients: g.astype(f32) * scale
            g = torch._foreach_mul([x.to(torch.float32) for x in g], scale)
            # mu = b1 * mu + (1 - b1) * g
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
            # nu = b2 * nu + (1 - b2) * g * g
            torch._foreach_mul_(v, b2)
            gg = torch._foreach_mul(g, 1 - b2)
            torch._foreach_mul_(gg, g)
            torch._foreach_add_(v, gg)
            del g, gg
            # delta = mhat / (sqrt(vhat) + eps) + wd * p32
            delta = torch._foreach_div(m, bc1)
            den = torch._foreach_div(v, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            torch._foreach_div_(delta, den)
            del den
            p32 = [q.to(torch.float32) for q in p]
            torch._foreach_add_(delta, torch._foreach_mul(p32, weight_decay))
            # p = (p32 - lr * delta).astype(p.dtype); a float32 parameter is
            # its own p32 and is written here
            torch._foreach_mul_(delta, lr_t)
            torch._foreach_sub_(p32, delta)
            if p32[0] is not p[0]:
                torch._foreach_copy_(p, p32)
            del delta, p32
        state["step"].copy_(step)
        return params, state, {"grad_norm": gnorm, "lr": lr_t}

    return Optimizer(init=init, update=update)
