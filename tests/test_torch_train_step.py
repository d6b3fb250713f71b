"""Port vs reference: whole train steps (``make_train_step`` with AdamW),
float32, on the CPU.

One step from the reference's reduced weights and a fresh optimizer state,
the same numpy batch on both sides, for every combination of
``microbatches`` in {1, 2}, ``remat`` and ``compress_bf16`` (dense), and with
``remat_policy="layer"`` for each family.  The metrics, both moments and
the parameters are compared with the tolerances of
``helpers/torch_lm.py``: moments within ``GRAD_TOL`` of each leaf's
largest value (plus one bf16 step of the value when the gradients were
compressed); parameters within ``P_ATOL`` plus how far Adam's update can
move for a gradient within that tolerance (``adam_allowance``: where the
reference's gradient is within the tolerance of zero, or near Adam's
epsilon, the first step's +-lr move may flip).
"""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
# one_torch_thread: an autouse fixture, imported to turn it on
from helpers.torch_lm import (  # noqa: E402, F401
    F32_TOL,
    FAMILY_ARCH,
    GRAD_TOL,
    adam_allowance,
    assert_adam_params_close,
    j_batch,
    one_torch_thread,
    reference,
    t_batch,
    train_batch_np,
    tree_np,
)

from repro import training as J  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro_torch.convert import lm_from_numpy, lm_tree_from_numpy  # noqa: E402
from repro_torch.models import loss_fn  # noqa: E402
from repro_torch.training import adamw, compress_bf16, make_train_step, warmup_cosine  # noqa: E402

B1 = 0.9
# float32 parameters after one step away from the sign-amplified elements:
# |p| <= ~1 and lr * |delta| <= ~1e-3, so rounding stays far below this
P_ATOL = 1e-6


def _step_both(cfg, params, *, microbatches=1, remat=False, compress=False):
    batch = train_batch_np(cfg, b=4, seed=11)
    j_model = j_build_model(cfg)
    j_opt = J.adamw(J.warmup_cosine(1e-3, 2, 10))
    j_step = jax.jit(J.make_train_step(
        j_model, j_opt, microbatches=microbatches, remat=remat,
        compress=J.compress_bf16 if compress else None))
    j_params, j_state, j_met = j_step(params, j_opt.init(params), j_batch(batch))

    model = lm_from_numpy(cfg, tree_np(params), device="cpu")
    opt = adamw(warmup_cosine(1e-3, 2, 10))
    state = opt.init(dict(model.named_parameters()))
    step = make_train_step(model, opt, microbatches=microbatches, remat=remat,
                           compress=compress_bf16 if compress else None)
    out, state, met = step(model, state, t_batch(batch))
    assert out is model
    return (j_params, j_state, j_met), (model, state, met)


def _check(cfg, ref, got, *, compress, what):
    fam = cfg.family
    (j_params, j_state, j_met), (model, state, met) = ref, got
    for k in ("loss", "nll", "aux"):
        np.testing.assert_allclose(float(met[k]), float(j_met[k]), rtol=F32_TOL[fam],
                                   atol=F32_TOL[fam], err_msg=f"{what}: {k}")
    np.testing.assert_allclose(float(met["grad_norm"]), float(j_met["grad_norm"]),
                               rtol=GRAD_TOL[fam], err_msg=what)
    np.testing.assert_allclose(float(met["lr"]), float(j_met["lr"]), rtol=1e-6)
    assert all(isinstance(v, torch.Tensor) for v in met.values())
    assert int(state["step"]) == int(j_state["step"]) == 1
    flip = 2 ** -7 if compress else 0.0     # one bf16 step of |g|
    for key, scale in (("mu", 1), ("nu", 2)):
        want = lm_tree_from_numpy(cfg, tree_np(j_state[key]), device="cpu")
        for name, w in want.items():
            bound = scale * (GRAD_TOL[fam] * float(w.abs().max()) + flip * w.abs())
            d = (state[key][name] - w).abs()
            assert bool((d <= bound + 1e-30).all()), (
                f"{what}: {key}[{name}] off by {float(d.max()):.3e}")
    lr = float(j_met["lr"])
    allowance = {}
    for name, mu in lm_tree_from_numpy(cfg, tree_np(j_state["mu"]), device="cpu").items():
        g = mu / (1 - B1)        # the reference's clipped (compressed) gradient
        dg = GRAD_TOL[fam] * float(g.abs().max()) + flip * g.abs()
        allowance[name] = adam_allowance(g, 0.0, 0.0, 1, lr, dg)
    assert_adam_params_close(dict(model.named_parameters()),
                             lm_tree_from_numpy(cfg, tree_np(j_params), device="cpu"),
                             allowance, P_ATOL, what)


@pytest.mark.parametrize("microbatches,remat,compress",
                         list(itertools.product([1, 2], [False, True], [False, True])))
def test_train_step_matches_reference(microbatches, remat, compress):
    cfg, _, params = reference(FAMILY_ARCH["dense"])
    ref, got = _step_both(cfg, params, microbatches=microbatches, remat=remat,
                          compress=compress)
    _check(cfg, ref, got, compress=compress,
           what=f"microbatches={microbatches} remat={remat} compress={compress}")


@pytest.mark.parametrize("family", sorted(FAMILY_ARCH))
def test_layer_remat_train_step_matches_reference(family):
    cfg, _, params = reference(FAMILY_ARCH[family])
    cfg = dataclasses.replace(cfg, remat_policy="layer")
    ref, got = _step_both(cfg, params, microbatches=2)
    _check(cfg, ref, got, compress=False, what=f"{family} layer remat")


def test_microbatch_gradients_accumulate_in_float32():
    """bf16 parameters: the microbatches' bf16 gradients are summed in
    float32 buffers (the reference's ``lax.scan`` carry), not in bf16."""
    cfg, _, params = reference(FAMILY_ARCH["dense"], "bfloat16")
    batch = t_batch(train_batch_np(cfg, b=4, seed=11))
    opt = adamw(warmup_cosine(1e-3, 2, 10))

    def fresh():
        model = lm_from_numpy(cfg, tree_np(params), device="cpu")
        return model, opt.init(dict(model.named_parameters()))

    model, state = fresh()
    make_train_step(model, opt, microbatches=2)(model, state, batch)
    got = {k: p.detach() for k, p in model.named_parameters()}

    def by_hand(accumulate_dtype):
        m, st = fresh()
        named = dict(m.named_parameters())
        acc = None
        for half in (slice(0, 2), slice(2, 4)):
            loss, _ = loss_fn(m, {k: v[half] for k, v in batch.items()})
            gs = torch.autograd.grad(loss, list(named.values()))
            gs = [g.to(accumulate_dtype) for g in gs]
            acc = gs if acc is None else [a + g for a, g in zip(acc, gs)]
        opt.update({k: a / 2 for k, a in zip(named, acc)}, st, named)
        return {k: p.detach() for k, p in named.items()}

    f32 = by_hand(torch.float32)
    assert all(torch.equal(got[k], f32[k]) for k in got)
    bf16 = by_hand(torch.bfloat16)
    assert not all(torch.equal(got[k], bf16[k]) for k in got)
