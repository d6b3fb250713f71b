"""Port vs reference: the LM model's pieces.

MoE routing (top-k ties toward the lower expert, as ``lax.top_k``) and
both dispatches, capacity-dropping and dropless; the chunked attention;
the KV cache writes (in place, start clamped as ``dynamic_update_slice``
clamps) and int8 rounding (half to even); the chunked scans against their
own one-step recurrences.  Weights are the reference's reduced ones
through ``repro_torch.convert.lm_from_numpy``; the port runs its plain
torch path on the CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from helpers.torch_lm import (  # noqa: E402
    assert_trees_close,
    port,
    reduced,
    reference,
    to_np,
)

from repro.models import layers as JL  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import mamba2 as TM2  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models import rwkv6 as TR6  # noqa: E402


# -- MoE ----------------------------------------------------------------------


def _moe_pair(name="dbrx-132b"):
    cfg, _, params = reference(name)
    jp = jax.tree_util.tree_map(lambda a: a[0], params["blocks"])["moe"]
    tm = port(name)
    return cfg, jp, tm.blocks[0].moe


def test_moe_sort_equals_onehot_dropless():
    cfg, jp, tp = _moe_pair()
    x = np.random.default_rng(0).normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    xt = torch.as_tensor(x)
    with torch.inference_mode():
        a, aux_a = TMOE.moe_sort(tp, xt, cfg, dropless=True)
        b, aux_b = TMOE.moe_onehot(tp, xt, cfg, dropless=True)
    np.testing.assert_allclose(to_np(a), to_np(b), rtol=1e-5, atol=1e-5)
    assert float(aux_a) == pytest.approx(float(aux_b), rel=1e-6)
    want, _ = JMOE.moe_sort(jp, jnp.asarray(x), cfg, dropless=True)
    np.testing.assert_allclose(to_np(a), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dropless", [False, True])
def test_moe_dispatch_matches_reference(dropless):
    """Both dispatches, capacity-dropping (train) and dropless, against the
    reference's on the same tokens."""
    cfg, jp, tp = _moe_pair("phi3.5-moe-42b-a6.6b")
    x = np.random.default_rng(1).normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    for j_fn, t_fn in ((JMOE.moe_onehot, TMOE.moe_onehot), (JMOE.moe_sort, TMOE.moe_sort)):
        want, aux_w = j_fn(jp, jnp.asarray(x), cfg, dropless=dropless)
        with torch.inference_mode():
            got, aux_g = t_fn(tp, torch.as_tensor(x), cfg, dropless=dropless)
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-4, atol=1e-4)
        assert float(aux_g) == pytest.approx(float(aux_w), rel=1e-5)


def test_moe_routing_indices_equal():
    """Top-k experts equal to ``lax.top_k``'s on inputs without ties, and
    ties broken toward the lower expert index as it does."""
    cfg, jp, tp = _moe_pair()
    x = np.random.default_rng(2).normal(size=(64, cfg.d_model)).astype(np.float32)
    probs = jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1)
    _, want = jax.lax.top_k(probs, cfg.moe_top_k)
    with torch.inference_mode():
        _, _, got = TMOE._route(tp, torch.as_tensor(x), cfg.moe_top_k)
    assert np.array_equal(to_np(got), np.asarray(want))
    # all-equal router logits: every expert ties
    tied = np.zeros((8, cfg.moe_experts), np.float32)
    _, want = jax.lax.top_k(jnp.asarray(tied), cfg.moe_top_k)
    got = torch.sort(torch.as_tensor(tied), dim=-1, descending=True, stable=True).indices
    assert np.array_equal(to_np(got[:, :cfg.moe_top_k]), np.asarray(want))
    with torch.no_grad():
        tp.router.zero_()
    try:
        with torch.inference_mode():
            _, _, idx = TMOE._route(tp, torch.as_tensor(x), cfg.moe_top_k)
        assert (to_np(idx) == np.arange(cfg.moe_top_k)).all()
    finally:
        with torch.no_grad():
            tp.router.copy_(torch.as_tensor(np.array(jp["router"])))


# -- layers -------------------------------------------------------------------


def test_chunked_attention_matches_reference():
    cfg = dataclasses.replace(reduced("qwen1.5-4b"), attn_impl="chunked", attn_chunk=16)
    _, _, params = reference("qwen1.5-4b")
    jp = jax.tree_util.tree_map(lambda a: a[0], params["blocks"])["attn"]
    tp = port("qwen1.5-4b").blocks[0].attn
    x = np.random.default_rng(3).normal(size=(2, 64, cfg.d_model)).astype(np.float32)
    for causal in (True, False):
        want = JL.attention(jp, jnp.asarray(x), cfg, causal=causal)
        with torch.inference_mode():
            got = TL.attention(tp, torch.as_tensor(x), cfg, causal=causal)
            naive = TL.attention(tp, torch.as_tensor(x), reduced("qwen1.5-4b"),
                                 causal=causal)
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(to_np(got), to_np(naive), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cache_len", [3, 7, 8, 12])
@pytest.mark.parametrize("quantized", [False, True])
def test_cache_append_clamps_like_dynamic_update_slice(cache_len, quantized):
    """Writes at ``cache_len``; past the end the start clamps to the last
    position, as the reference's ``dynamic_update_slice`` does."""
    rng = np.random.default_rng(cache_len)
    new = rng.normal(size=(2, 1, 2, 16)).astype(np.float32)
    jk, jv = JL.make_kv_cache(2, 8, 2, 16, jnp.float32, quantized)
    jk, jv = JL._cache_append(jk, jv, jnp.asarray(new), jnp.asarray(-new),
                              jnp.int32(cache_len))
    tk, tv = TL.make_kv_cache(2, 8, 2, 16, torch.float32, quantized, "cpu")
    tk2, tv2 = TL._cache_append(tk, tv, torch.as_tensor(new), torch.as_tensor(-new),
                                cache_len)
    assert tk2 is tk and tv2 is tv                     # written in place
    for got, want in ((tk, jk), (tv, jv)):
        got = {k: to_np(v) for k, v in got.items()} if quantized else to_np(got)
        assert_trees_close(got, want, 1e-6, f"cache_len {cache_len}")


def test_quant_rounds_half_to_even_like_the_reference():
    x = np.array([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0]], np.float32)   # scale 1
    want = JL._quant(jnp.asarray(x))
    got = TL._quant(torch.as_tensor(x))
    assert np.array_equal(to_np(got["q"]), np.asarray(want["q"]))
    np.testing.assert_array_equal(to_np(got["scale"]), np.asarray(want["scale"]))
    xb = jnp.asarray(np.random.default_rng(0).normal(size=(4, 32)), jnp.bfloat16)
    got = TL._quant(torch.as_tensor(np.array(xb.astype(jnp.float32))).to(torch.bfloat16))
    want = JL._quant(xb)
    assert np.array_equal(to_np(got["q"]), np.asarray(want["q"]))


def test_mamba2_chunked_equals_decode_chain():
    """The port's chunked SSD == its step-by-step recurrence."""
    cfg = reduced("zamba2-2.7b")
    p = port("zamba2-2.7b").blocks[0][0].mamba
    b, s = 2, 64
    x = torch.as_tensor(np.random.default_rng(4).normal(
        size=(b, s, cfg.d_model)).astype(np.float32))
    d_inner, heads, hd = TM2.ssm_dims(cfg)
    with torch.inference_mode():
        full, state = TM2.mamba2_chunked(p, x, cfg, chunk=16, return_state=True)
        st = {"ssm": torch.zeros((b, heads, hd, cfg.ssm_state)),
              "conv": torch.zeros((b, cfg.ssm_conv - 1, d_inner))}
        outs = []
        for t in range(s):
            o, st = TM2.mamba2_decode(p, x[:, t:t + 1], cfg, st)
            outs.append(o)
    np.testing.assert_allclose(to_np(torch.cat(outs, 1)), to_np(full), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(to_np(st["ssm"]), to_np(state["ssm"]), rtol=2e-3, atol=2e-3)
    with pytest.raises(AssertionError):
        TM2.mamba2_chunked(p, x[:, :60], cfg, chunk=16)


def test_rwkv6_chunked_equals_decode_chain():
    cfg = reduced("rwkv6-1.6b")
    p = port("rwkv6-1.6b").blocks[0].tm
    b, s = 2, 128
    x = torch.as_tensor(np.random.default_rng(5).normal(
        size=(b, s, cfg.d_model)).astype(np.float32))
    heads, hd = TR6.rwkv_dims(cfg)
    with torch.inference_mode():
        full, state = TR6.rwkv6_time_mix(p, x, cfg, return_state=True)
        st = {"wkv": torch.zeros((b, heads, hd, hd)), "shift": torch.zeros((b, 1, cfg.d_model))}
        outs = []
        for t in range(s):
            o, st = TR6.rwkv6_time_mix_decode(p, x[:, t:t + 1], cfg, st)
            outs.append(o)
    np.testing.assert_allclose(to_np(torch.cat(outs, 1)), to_np(full), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(to_np(st["wkv"]), to_np(state["wkv"]), rtol=1e-3, atol=1e-3)
    with pytest.raises(AssertionError):
        TR6.rwkv6_time_mix(p, x[:, :100], cfg)
