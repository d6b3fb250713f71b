"""Shared set-up of the LM parity tests (``tests/test_torch_models.py``,
``tests/test_torch_serve_step.py``): the reference's reduced model and
weights, the port's model holding the same weights (through
``repro_torch.convert.lm_from_numpy``), inputs from a numpy seed, and the
port's caches in the reference's stacked layout."""
from __future__ import annotations

from functools import lru_cache

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

N_PATCHES = 8   # the vlm stub's patch prefix in these tests


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
