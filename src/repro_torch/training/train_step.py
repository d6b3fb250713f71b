"""Training step factory: gradient accumulation, mixed precision,
activation remat, an optional gradient compression hook.  Counterpart of
``repro.training.train_step``.

The reference's step is a pure function of ``(params, opt_state, batch)``.
Here the parameters live in the model, and the step writes them and the
optimizer state in place (a 4 B-parameter model cannot afford a second
copy of its parameters); it returns ``(model, opt_state, metrics)`` so
callers read as the reference's do.  Gradients are taken with
``torch.autograd.grad``; with ``microbatches > 1`` they are summed into
float32 buffers, as the reference's ``lax.scan`` sums them.  Metrics are
device tensors: the step never waits on the host.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from ..models import transformer as T
from .optimizer import Optimizer


def _split_microbatches(batch: dict, k: int) -> list[dict]:
    """``k`` microbatches along the leading axis (which ``k`` must divide),
    in order."""
    out = [{} for _ in range(k)]
    for key, x in batch.items():
        b = x.shape[0]
        if b % k:
            raise ValueError(f"batch {key!r} of {b} rows does not split into {k} "
                             f"microbatches")
        for i in range(k):
            out[i][key] = x[i * (b // k):(i + 1) * (b // k)]
    return out


def compress_bf16(grads: dict) -> dict:
    """Gradient compression: a bf16 round-trip of every leaf (2x fewer
    collective bytes when the data-parallel reduce runs in bf16)."""
    return {k: g.to(torch.bfloat16).to(torch.float32) for k, g in grads.items()}


def make_train_step(
    model: T.LM,
    optimizer: Optimizer,
    *,
    microbatches: int = 1,
    remat: bool = False,
    compress: Callable | None = None,
) -> Callable:
    """``train_step(model, opt_state, batch) -> (model, opt_state, metrics)``
    for ``model``: ``metrics`` holds ``loss`` (the microbatch mean), ``nll``
    and ``aux`` (the last microbatch's), ``grad_norm`` and ``lr``.
    ``remat=True`` recomputes the whole loss in backward (the reference's
    ``jax.checkpoint(loss_fn)``)."""
    loss_fn = T.loss_fn
    if remat:
        def loss_fn(m, batch):
            # the forward draws no random numbers: no RNG state to stash
            return checkpoint(T.loss_fn, m, batch, use_reentrant=False,
                              preserve_rng_state=False)

    params = dict(model.named_parameters())

    def grad_of(batch):
        loss, metrics = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            dict(zip(params, grads))

    def train_step(m: T.LM, opt_state: dict, batch: dict):
        if m is not model:
            raise ValueError("a train step updates the model it was made for")
        if microbatches == 1:
            loss, metrics, grads = grad_of(batch)
        else:
            acc = None
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            for mb in _split_microbatches(batch, microbatches):
                loss_k, metrics, grads = grad_of(mb)
                loss = loss + loss_k
                g32 = [g.to(torch.float32) for g in grads.values()]
                if acc is None:
                    acc = [torch.zeros_like(g) for g in g32]
                torch._foreach_add_(acc, g32)
                del grads, g32
            loss = loss / microbatches
            torch._foreach_div_(acc, microbatches)
            grads = dict(zip(params, acc))
        if compress is not None:
            grads = compress(grads)
        _, opt_state, opt_metrics = optimizer.update(grads, opt_state, params)
        metrics["loss"] = loss
        metrics.update(opt_metrics)
        return model, opt_state, metrics

    return train_step
