"""Port vs reference: ``serving/serve_step.py``'s ``greedy_generate``.

``greedy_generate`` on the reference's reduced weights (through
``repro_torch.convert.lm_from_numpy``) gives the reference's tokens for
the dense, moe and ssm families with bf16-layout and int8 KV caches, and
for the hybrid family with the bf16 layout.  The hybrid family with int8
KV is the port's deliberate divergence: the reference's ``greedy_generate``
leaves the shared attention block's int8 cache empty, and the test shows
its decode logits off the full-sequence forward while the port's stay
within the dense family's int8 error.  The steps and the SPG half are in
``test_torch_serve_step_units.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from helpers.torch_lm import (  # noqa: E402
    FAMILY_ARCH,
    batch_np,
    port,
    reference,
    to_np,
)

from repro.serving import greedy_generate as j_greedy  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import greedy_generate  # noqa: E402

PROMPT, N_NEW = 64, 8


def _prompt(cfg, seed=3):
    return batch_np(cfg, b=2, s=PROMPT, seed=seed)["tokens"]


@pytest.mark.parametrize("family,kv_quant", [
    ("dense", False), ("dense", True), ("moe", False), ("moe", True),
    ("ssm", False), ("ssm", True), ("hybrid", False)])
def test_greedy_tokens_equal_the_references(family, kv_quant):
    """Every combination but hybrid with int8 KV, where the reference is
    faulty (``test_hybrid_int8_kv_fixes_the_references_empty_cache``)."""
    name = FAMILY_ARCH[family]
    cfg, jm, params = reference(name)
    prompt = _prompt(cfg)
    want = np.asarray(j_greedy(jm, params, prompt, N_NEW, kv_quant=kv_quant))
    got = greedy_generate(port(name), prompt, N_NEW, kv_quant=kv_quant)
    assert got.dtype == torch.int32 and got.shape == (2, N_NEW)
    assert np.array_equal(to_np(got), want)


def _first_decode_gap_reference(name):
    """The reference's greedy set-up replayed (``repro/serving/
    serve_step.py``'s hybrid branch keeps the fresh int8 buffers) and one
    known token decoded: the largest gap to the full-sequence forward."""
    cfg, jm, params = reference(name)
    toks = _prompt(cfg)
    nxt = np.full((2, 1), 7, np.int32)
    _, pre = jm.prefill(params, batch={"tokens": jnp.asarray(toks)})
    cache = dict(jm.init_decode_cache(2, PROMPT + 4, kv_quant=True))
    if cfg.family == "hybrid":
        cache["mamba"] = pre["mamba"]           # "attn" stays empty, as there
    else:
        from repro.models.layers import _quant
        k_pre, v_pre = pre["layers"]
        bufs = []
        for buf, x in zip(cache["layers"], (k_pre, v_pre)):
            q = _quant(x)
            bufs.append({"q": buf["q"].at[:, :, :PROMPT].set(q["q"]),
                         "scale": buf["scale"].at[:, :, :PROMPT].set(q["scale"])})
        cache["layers"] = tuple(bufs)
    logits, _ = jm.decode(params, cache=cache, cache_len=jnp.int32(PROMPT),
                          tokens=jnp.asarray(nxt))
    full, _ = jm.forward(params, batch={"tokens": jnp.asarray(
        np.concatenate([toks, nxt], axis=1))})
    return np.abs(np.asarray(logits[:, 0]) - np.asarray(full[:, PROMPT])).max()


def _first_decode_gap_port(name):
    """The port's ``greedy_generate`` with int8 KV: its second step's logits
    against the full-sequence forward over the prompt and the first token."""
    cfg, _, _ = reference(name)
    tm = port(name)
    toks = _prompt(cfg)
    out, logits = greedy_generate(tm, toks, 2, kv_quant=True, return_logits=True)
    seq = np.concatenate([toks, to_np(out[:, :1])], axis=1)
    with torch.inference_mode():
        full, _ = T.forward(tm, {"tokens": torch.as_tensor(seq)})
    return np.abs(to_np(logits[:, 1]) - to_np(full[:, PROMPT])).max()


def test_hybrid_int8_kv_fixes_the_references_empty_cache():
    """The reference's hybrid int8 decode attends to zero keys (its logits
    miss the forward's by > 0.1; logits reach ~4); the port quantises the
    prompt's K/V into the cache and stays within the dense family's int8
    quantisation error (< 0.05)."""
    assert _first_decode_gap_reference(FAMILY_ARCH["hybrid"]) > 0.1
    assert _first_decode_gap_reference(FAMILY_ARCH["dense"]) < 0.05
    assert _first_decode_gap_port(FAMILY_ARCH["hybrid"]) < 0.05
    assert _first_decode_gap_port(FAMILY_ARCH["dense"]) < 0.05


def test_greedy_cache_never_needs_the_clamp():
    """``greedy_generate`` decodes positions ``s .. s + n_new - 2`` into a
    cache of ``s + n_new``: no write reaches the clamped start."""
    name = FAMILY_ARCH["dense"]
    tm = port(name)
    prompt = _prompt(tm.cfg)
    writes = []
    real = T.L._cache_append

    def spy(k_cache, v_cache, k_new, v_new, cache_len):
        writes.append((int(cache_len), k_cache.shape[1]))
        return real(k_cache, v_cache, k_new, v_new, cache_len)

    T.L._cache_append = spy
    try:
        greedy_generate(tm, prompt, N_NEW)
    finally:
        T.L._cache_append = real
    assert writes and all(at <= s_max - 1 for at, s_max in writes)
    assert {at for at, _ in writes} == set(range(PROMPT, PROMPT + N_NEW - 1))
    assert {s_max for _, s_max in writes} == {PROMPT + N_NEW}


def test_greedy_takes_a_tensor_or_an_array():
    """The prompt may be a numpy array, a list or a tensor on the model's
    device; the tokens are the same."""
    tm = port(FAMILY_ARCH["dense"])
    prompt = _prompt(tm.cfg)
    want = greedy_generate(tm, prompt, 3)
    assert torch.equal(greedy_generate(tm, torch.as_tensor(prompt), 3), want)
    assert torch.equal(greedy_generate(tm, prompt.tolist(), 3), want)
