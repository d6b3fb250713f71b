"""Shared set-up of the LM parity tests (``tests/test_torch_models.py``,
``tests/test_torch_serve_step.py``, ``tests/test_torch_training.py``,
``tests/test_torch_data_checkpoint.py``): the reference's reduced model and
weights, the port's model holding the same weights (through
``repro_torch.convert.lm_from_numpy``), inputs from a numpy seed, the
port's caches in the reference's stacked layout, and the float32
tolerances of logits, gradients and AdamW updates.

    PYTHONPATH=src:tests python -m helpers.torch_lm

prints the one-ulp sensitivity of the reference's gradients that
``GRAD_TOL`` is derived from."""
from __future__ import annotations

from functools import lru_cache

import pytest
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCHS
from repro.models import build_model as j_build
from repro_torch.convert import lm_from_numpy

# one architecture of each family, for the cases run once per family
FAMILY_ARCH = {
    "dense": "qwen1.5-4b",
    "moe": "phi3.5-moe-42b-a6.6b",
    "ssm": "rwkv6-1.6b",
    "hybrid": "zamba2-2.7b",
    "audio": "hubert-xlarge",
    "vlm": "internvl2-76b",
}

# float32 logits tolerance (abs and rel) per family.  The attention
# families hold 1e-4.  The recurrent scans difference running sums of log
# decays (up to ~1e3 over a 64-step mamba2 chunk), so f32 rounding of
# their inputs is magnified: a one-ulp random perturbation of the
# reference's own weights moves its reduced logits by 4.4e-6 (dense),
# 3.4e-5 (rwkv6) and 2.2e-4 (zamba2).  The bound for those two families
# is about 20x that sensitivity.
F32_TOL = {"dense": 1e-4, "moe": 1e-4, "audio": 1e-4, "vlm": 1e-4,
           "ssm": 5e-4, "hybrid": 5e-3}

# float32 gradient tolerance per family, relative to each leaf's largest
# |gradient|: max |g_port - g_ref| <= GRAD_TOL * max |g_ref|.  Derived as
# F32_TOL was: a one-ulp random perturbation of the reference's own weights
# moves its gradients (``loss_fn`` on ``train_batch_np(cfg)``) by 2.4e-6
# (dense), 2.0e-6 (moe), 1.2e-6 (audio), 1.8e-6 (vlm), 1.4e-5 (rwkv6) and
# 1.8e-4 (zamba2) of a leaf's largest value (``grad_ulp_sensitivity``);
# each bound is about 20x that.
GRAD_TOL = {"dense": 5e-5, "moe": 5e-5, "audio": 5e-5, "vlm": 5e-5,
            "ssm": 3e-4, "hybrid": 4e-3}

N_PATCHES = 8   # the vlm stub's patch prefix in these tests


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread for a module of tiny-model tests (import
    it into the module to turn it on): the suite runs files in parallel
    workers, and eight threads per worker over tiny ops spend their time
    contending for the cores.  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reduced(name: str, dtype: str = "float32"):
    return ARCHS[name].reduced(dtype=dtype)


@lru_cache(maxsize=None)
def reference(name: str, dtype: str = "float32", seed: int = 0):
    """(cfg, reference Model, params) for the reduced config."""
    cfg = reduced(name, dtype)
    model = j_build(cfg)
    return cfg, model, model.init(jax.random.PRNGKey(seed))


def tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port(name: str, dtype: str = "float32", seed: int = 0):
    """The port's LM (CPU) with the reference's weights."""
    cfg, _, params = reference(name, dtype, seed)
    return lm_from_numpy(cfg, tree_np(params), device="cpu")


def batch_np(cfg, b: int = 2, s: int = 64, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_frames":
        return {"features": rng.normal(size=(b, s, cfg.frontend_dim)).astype(np.float32)}
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.frontend == "vision_patches":
        out["patches"] = rng.normal(size=(b, N_PATCHES, cfg.frontend_dim)).astype(np.float32)
    return out


def train_batch_np(cfg, b: int = 2, s: int = 64, seed: int = 0) -> dict:
    """``batch_np`` plus the encoder-only model's ``targets`` and
    ``loss_mask`` (30% of positions)."""
    out = batch_np(cfg, b, s, seed)
    if cfg.encoder_only:
        rng = np.random.default_rng(seed + 1)
        out["targets"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
        out["loss_mask"] = rng.random((b, s)) < 0.3
    return out


def grad_ulp_sensitivity(name: str) -> float:
    """How far a one-ulp random perturbation of the reference's reduced f32
    weights moves its gradients: the largest over leaves of max |dg| / max
    |g|."""
    from repro.models import transformer as JT

    cfg, _, params = reference(name)
    batch = j_batch(train_batch_np(cfg))
    grad = jax.jit(jax.grad(lambda p: JT.loss_fn(p, cfg, batch)[0]))
    rng = np.random.default_rng(1)

    def bump(x):
        x = np.asarray(x)
        toward = (rng.choice([-1, 1], size=x.shape) * np.inf).astype(x.dtype)
        return jnp.asarray(np.nextafter(x, toward))

    g0 = jax.tree_util.tree_leaves(grad(params))
    g1 = jax.tree_util.tree_leaves(grad(jax.tree_util.tree_map(bump, params)))
    return max(float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(a).max())
               for a, b in zip(g0, g1) if np.abs(a).max() > 0)


def adam_allowance(g, m_prev, v_prev, step: int, lr: float, dg,
                   b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8):
    """How far AdamW's update ``lr * mhat / (sqrt(vhat) + eps)`` can move
    (elementwise, float64) when the gradient ``g`` moves by up to ``dg``,
    from moments ``m_prev``, ``v_prev`` at ``step``: the largest change over
    nine points spanning ``[g - dg, g + dg]``.  At the first step the update
    is ``g / (|g| + eps)``, about +-1 whatever the gradient's size, so where
    ``|g| <= dg`` a rounding-level gradient may flip it: up to ``2 * lr``;
    where ``|g|`` is far above ``dg`` and ``eps``, about nothing."""
    g, m_prev, v_prev, dg = (torch.as_tensor(t).double() for t in (g, m_prev, v_prev, dg))
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step

    def upd(gp):
        m = b1 * m_prev + (1 - b1) * gp
        v = b2 * v_prev + (1 - b2) * gp * gp
        return (m / bc1) / (torch.sqrt(v / bc2) + eps)

    u0 = upd(g)
    return lr * torch.stack([(upd(g + t * dg) - u0).abs()
                             for t in np.linspace(-1.0, 1.0, 9)]).amax(0)


def assert_adam_params_close(got: dict, want: dict, allowance: dict, atol: float,
                             what: str) -> None:
    """Parameters after an AdamW step, ``{name: tensor}`` each, against the
    reference's: within ``atol`` plus ``allowance[name]``
    (``adam_allowance`` of the reference's gradient and the gradient
    tolerance) elementwise."""
    for name, w in want.items():
        d = (got[name].detach().cpu().double() - w.double()).abs()
        bound = allowance[name] + atol
        worst = int(torch.argmax(d - bound))
        assert bool((d <= bound).all()), (
            f"{what}: {name} differs by {float(d.flatten()[worst]):.3e} (bound "
            f"{float(bound.flatten()[worst]):.3e})")


def j_batch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def t_batch(batch: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def to_np(x) -> np.ndarray:
    """A port tensor (any float dtype) as f32 numpy; other dtypes as they are."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def stacked(tree):
    """The port's cache (lists per layer / group) in the reference's layout
    (leaves stacked along a leading axis), as numpy."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: stacked(v) for k, v in tree.items()}
    if isinstance(tree, list):
        parts = [stacked(t) for t in tree]
        return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *parts)
    if isinstance(tree, tuple):
        return tuple(stacked(t) for t in tree)
    return to_np(tree)


def assert_trees_close(got, want, tol: float, what: str) -> None:
    """``got`` and ``want`` (numpy trees of one structure) within ``tol``
    abs and rel."""
    g_leaves, g_def = jax.tree_util.tree_flatten(got)
    w_leaves, w_def = jax.tree_util.tree_flatten(tree_np(want))
    assert g_def == w_def, (what, g_def, w_def)
    for g, w in zip(g_leaves, w_leaves):
        np.testing.assert_allclose(to_np(g), to_np(w), rtol=tol, atol=tol,
                                   err_msg=what)


if __name__ == "__main__":
    for fam, arch in FAMILY_ARCH.items():
        print(f"{fam:7s} {arch:22s} one-ulp gradient sensitivity "
              f"{grad_ulp_sensitivity(arch):.2e}")
