"""Port vs reference: the LM decode step.

One ``decode_step`` after a 64-token prefill, on a bf16-layout and an int8
KV cache, for every decoder architecture (the reference's reduced weights
through ``repro_torch.convert.lm_from_numpy``; tolerances stated in
``helpers/torch_lm.py``): logits and the new cache.  The model's pieces
are in ``test_torch_models_parts.py``.  The port runs its plain torch path
on the CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from helpers.torch_lm import (  # noqa: E402
    F32_TOL,
    N_PATCHES,
    batch_np,
    j_batch,
    port,
    reference,
    stacked,
    t_batch,
    to_np,
    tree_np,
)

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.serve_step import _write_prefix  # noqa: E402

DECODERS = sorted(n for n, c in J_ARCHS.items() if not c.encoder_only)
INT8_TOL = 1e-3   # one int8 code rounding the other way at a .5 boundary
                  # moves the reduced logits by ~2e-4


def _prefix_len(cfg, s):
    return s + (N_PATCHES if cfg.frontend == "vision_patches" else 0)


def _j_decode_cache(cfg, jm, pre, s, total, kv_quant):
    """The reference's prefill cache written into a decode cache of
    ``total`` positions (int8: quantised by the reference's ``_quant``)."""
    cache = dict(jm.init_decode_cache(2, total, kv_quant=kv_quant))
    key = "attn" if cfg.family == "hybrid" else "layers"
    bufs = []
    for buf, x in zip(cache[key], pre[key]):
        if isinstance(buf, dict):
            q = JL._quant(x)
            bufs.append({"q": buf["q"].at[:, :, :s].set(q["q"]),
                         "scale": buf["scale"].at[:, :, :s].set(q["scale"])})
        else:
            bufs.append(buf.at[:, :, :s].set(x.astype(buf.dtype)))
    cache[key] = tuple(bufs)
    if cfg.family == "hybrid":
        cache["mamba"] = pre["mamba"]
    return cache


def _t_decode_cache(cfg, pre, s, total, kv_quant):
    with torch.inference_mode():
        cache = T.init_decode_cache(cfg, 2, total, kv_quant=kv_quant, device="cpu")
        key = "attn" if cfg.family == "hybrid" else "layers"
        for (k_buf, v_buf), (k_pre, v_pre) in zip(cache[key], pre[key]):
            _write_prefix(k_buf, k_pre, s)
            _write_prefix(v_buf, v_pre, s)
        if cfg.family == "hybrid":
            cache["mamba"] = pre["mamba"]
    return cache


def _assert_caches_close(got, want, tol, what):
    """Cache trees within ``tol``; int8 codes within one step (a value
    that differs by the float tolerance may round to the neighbouring
    code at a .5 boundary)."""
    g_leaves, g_def = jax.tree_util.tree_flatten(got)
    w_leaves, w_def = jax.tree_util.tree_flatten(tree_np(want))
    assert g_def == w_def, what
    for g, w in zip(g_leaves, w_leaves):
        if w.dtype == np.int8:
            assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1, what
        else:
            np.testing.assert_allclose(g, to_np(w), rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16_layout", "int8"])
@pytest.mark.parametrize("name", DECODERS)
def test_decode_step_matches_reference(name, kv_quant):
    """One token after a 64-token prefill; the recurrent families keep
    their prefill state (no KV cache, so int8 is the same step)."""
    cfg, jm, params = reference(name)
    tm = port(name)
    batch = batch_np(cfg, seed=2)
    tok = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    _, j_pre = jm.prefill(params, batch=j_batch(batch))
    _, t_pre = T.prefill(tm, t_batch(batch))
    s = _prefix_len(cfg, 64)
    if cfg.family == "ssm":
        j_cache, t_cache = j_pre, t_pre
    else:
        j_cache = _j_decode_cache(cfg, jm, j_pre, s, s + 4, kv_quant)
        t_cache = _t_decode_cache(cfg, t_pre, s, s + 4, kv_quant)
    want, j_new = jm.decode(params, cache=j_cache, cache_len=jnp.int32(s),
                            tokens=jnp.asarray(tok))
    got, t_new = T.decode_step(tm, t_cache, s, torch.as_tensor(tok))
    tol = max(F32_TOL[cfg.family], INT8_TOL if kv_quant else 0.0)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=tol, atol=tol)
    j_new = dict(j_new)
    j_new.pop("x0_last", None)
    t_new = {k: v for k, v in t_new.items() if k != "x0_last"}
    _assert_caches_close(stacked(t_new), j_new, tol, f"{name} decode cache")
