"""Port vs reference: the training half of the LM substrate (``loss_fn``
and autograd, ``layer`` remat, AdamW), and the reference's own training
tests (``tests/test_substrate.py``) mirrored on the port.

The reference's reduced float32 weights go through ``repro_torch.convert``
and the same numpy batch through ``jax.value_and_grad`` of the reference's
``loss_fn`` and the port's ``loss_fn`` under autograd, for all ten
architectures (``train=True``: the MoE layers drop over capacity).  The
tolerances are stated in ``helpers/torch_lm.py`` (``F32_TOL`` for the loss,
``GRAD_TOL`` per gradient leaf).  Whole train steps are in
``test_torch_train_step.py``; the data pipeline and checkpoints in
``test_torch_data_checkpoint.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
# one_torch_thread: an autouse fixture, imported to turn it on
from helpers.torch_lm import (  # noqa: E402, F401
    F32_TOL,
    FAMILY_ARCH,
    GRAD_TOL,
    j_batch,
    one_torch_thread,
    port,
    reference,
    t_batch,
    train_batch_np,
    tree_np,
)

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import adamw as j_adamw  # noqa: E402
from repro.training import warmup_cosine as j_warmup_cosine  # noqa: E402
from repro_torch.convert import lm_from_numpy, lm_tree_from_numpy, opt_state_from_numpy  # noqa: E402
from repro_torch.data import SyntheticLM, SyntheticLMConfig  # noqa: E402
from repro_torch.models import loss_fn  # noqa: E402
from repro_torch.training import (  # noqa: E402
    adamw,
    compress_bf16,
    global_norm,
    make_train_step,
    warmup_cosine,
)


def _port_grads(model, batch):
    loss, metrics = loss_fn(model, t_batch(batch))
    named = list(model.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named], materialize_grads=True)
    return loss, metrics, dict(zip([n for n, _ in named], grads))


def _check_grads(cfg, model, params, batch, what):
    fam = cfg.family
    (j_loss, j_met), j_grads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, cfg, b), has_aux=True))(params, j_batch(batch))
    loss, metrics, grads = _port_grads(model, batch)
    for got, want in ((loss, j_loss), (metrics["nll"], j_met["nll"]),
                      (metrics["aux"], j_met["aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=F32_TOL[fam],
                                   atol=F32_TOL[fam], err_msg=what)
    want = lm_tree_from_numpy(cfg, tree_np(j_grads), device="cpu")
    assert set(want) == set(grads)
    for name, w in want.items():
        scale = float(w.abs().max())
        err = float((grads[name] - w).abs().max())
        assert err <= GRAD_TOL[fam] * scale, (
            f"{what}: {name} gradient off by {err:.3e} (tolerance "
            f"{GRAD_TOL[fam]:g} x {scale:.3e})")
    return grads


@pytest.mark.parametrize("name", sorted(J_ARCHS))
def test_loss_and_every_gradient_match_reference(name):
    cfg, _, params = reference(name)
    _check_grads(cfg, port(name), params, train_batch_np(cfg), name)


@pytest.mark.parametrize("dispatch", ["onehot", "sort"])
def test_moe_dropping_dispatch_gradients_match_reference(dispatch):
    """Both dispatches under autograd with tokens dropped: 128 tokens of 4
    experts x top-2 at capacity factor 0.5 (32 slots per expert, ~64
    routed), the sort dispatch through ``xe[dest] = ...`` and the
    combine's ``index_add_``."""
    cfg, _, params = reference(FAMILY_ARCH["moe"])
    cfg = dataclasses.replace(cfg, moe_dispatch=dispatch, moe_capacity_factor=0.5)
    model = lm_from_numpy(cfg, tree_np(params), device="cpu")
    _check_grads(cfg, model, params, train_batch_np(cfg), f"moe {dispatch}")


def test_vlm_and_masked_loss_match_reference():
    """The vlm patch prefix dropped before the shift, with a ``loss_mask``."""
    cfg, _, params = reference(FAMILY_ARCH["vlm"])
    batch = train_batch_np(cfg, seed=3)
    batch["loss_mask"] = np.random.default_rng(3).random(batch["tokens"].shape) < 0.5
    _check_grads(cfg, port(FAMILY_ARCH["vlm"]), params, batch, "vlm masked")


@pytest.mark.parametrize("family", sorted(FAMILY_ARCH))
def test_layer_remat_gives_the_same_gradients(family):
    """``remat_policy="layer"`` (each block, and the hybrid's shared block,
    recomputed in backward) changes no value."""
    name = FAMILY_ARCH[family]
    cfg, _, params = reference(name)
    batch = train_batch_np(cfg)
    base = _port_grads(port(name), batch)
    remat = lm_from_numpy(dataclasses.replace(cfg, remat_policy="layer"),
                          tree_np(params), device="cpu")
    got = _port_grads(remat, batch)
    assert torch.equal(got[0], base[0])
    for k, g in base[2].items():
        assert torch.equal(got[2][k], g), k


def test_forward_and_loss_carry_no_inference_mode():
    model = port(FAMILY_ARCH["dense"])
    cfg = model.cfg
    loss, _ = model.loss(t_batch(train_batch_np(cfg)))
    assert loss.requires_grad and not loss.is_inference()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip_norm", [1.0, 1e3])
def test_adamw_update_matches_reference(dtype, clip_norm):
    """``update`` alone on the same numpy gradients and state (step 3 ->
    4, so both bias corrections and the schedule's cosine branch count):
    parameters, moments, grad_norm and lr within float32 rounding (a few
    ulps of each leaf's largest value: ``b1 * mu + (1 - b1) * g`` may cancel;
    bf16 parameters within one bf16 step)."""
    cfg, _, params = reference(FAMILY_ARCH["dense"], dtype)
    rng = np.random.default_rng(7)

    def rand_like(tree, scale, positive=False):
        return jax.tree_util.tree_map(
            lambda x: np.abs(rng.normal(size=x.shape)).astype(np.float32) * scale
            if positive else (rng.normal(size=x.shape) * scale).astype(np.float32),
            tree)

    grads = jax.tree_util.tree_map(lambda x: x.astype(np.asarray(params["embed"]).dtype),
                                   rand_like(tree_np(params), 0.05))
    state = {"mu": rand_like(tree_np(params), 1e-2),
             "nu": rand_like(tree_np(params), 1e-4, positive=True),
             "step": np.int32(3)}
    j_opt = j_adamw(j_warmup_cosine(1e-2, 2, 10), clip_norm=clip_norm)
    j_params, j_state, j_met = jax.jit(j_opt.update)(
        jax.tree_util.tree_map(jnp.asarray, grads),
        jax.tree_util.tree_map(jnp.asarray, state), params)

    model = port(FAMILY_ARCH["dense"], dtype)
    named = dict(model.named_parameters())
    t_state = opt_state_from_numpy(cfg, state, device="cpu")
    t_grads = lm_tree_from_numpy(cfg, tree_np(grads), device="cpu")
    opt = adamw(warmup_cosine(1e-2, 2, 10), clip_norm=clip_norm)
    out, t_state, met = opt.update(t_grads, t_state, named)
    assert out is named and int(t_state["step"]) == 4
    assert t_state["step"].dtype == torch.int32
    np.testing.assert_allclose(float(met["grad_norm"]), float(j_met["grad_norm"]),
                               rtol=2e-6)
    np.testing.assert_allclose(float(met["lr"]), float(j_met["lr"]), rtol=1e-6)
    for key in ("mu", "nu"):
        want = lm_tree_from_numpy(cfg, tree_np(j_state[key]), device="cpu")
        for k, w in want.items():
            torch.testing.assert_close(t_state[key][k], w, rtol=4e-6,
                                       atol=4e-6 * float(w.abs().max()))
    want = lm_tree_from_numpy(cfg, tree_np(j_params), device="cpu")
    for k, w in want.items():
        p = named[k].detach()
        assert p.dtype == w.dtype
        if dtype == "float32":
            torch.testing.assert_close(p, w, rtol=4e-6, atol=4e-6 * float(w.abs().max()))
        else:   # a float32 difference of one ulp may round to the next bf16
            torch.testing.assert_close(p.float(), w.float(), rtol=2 ** -7, atol=0)


def test_global_norm_and_schedule_are_float32():
    g = {"a": torch.full((3,), 2.0, dtype=torch.bfloat16), "b": torch.ones(4)}
    n = global_norm(g)
    assert n.dtype == torch.float32 and float(n) == 4.0
    sched = warmup_cosine(1e-3, 4, 20)
    j_sched = j_warmup_cosine(1e-3, 4, 20)
    for step in (0, 1, 4, 9, 20, 30):
        got = sched(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == float(j_sched(jnp.int32(step)))


def test_compress_bf16_rounds_through_bf16():
    g = {"w": torch.tensor([1.0 + 2 ** -10, 3.0])}
    out = compress_bf16(g)
    assert out["w"].dtype == torch.float32 and out["w"].tolist() == [1.0, 3.0]


# ---------------------------------------------------------------------------
# tests/test_substrate.py on the port, in its bf16 set-up
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_setup():
    """The reference's set-up: ``qwen1.5-4b().reduced()`` (bf16), the
    reference's initial weights, ``adamw(warmup_cosine(2e-2, 3, 100),
    weight_decay=0.01)``, batches of 8 x 32.  ``fresh()`` gives a model
    at the initial weights and its optimizer state."""
    cfg, _, params = reference(FAMILY_ARCH["dense"], "bfloat16")
    assert cfg.dtype == "bfloat16"
    host = tree_np(params)
    opt = adamw(warmup_cosine(2e-2, 3, 100), weight_decay=0.01)
    data = SyntheticLM(SyntheticLMConfig(cfg.vocab_size, seq_len=32, global_batch=8))

    def fresh():
        model = lm_from_numpy(cfg, host, device="cpu")
        return model, opt.init(dict(model.named_parameters()))
    return cfg, opt, data, fresh


def _batch(data, step):
    return {k: torch.as_tensor(v) for k, v in data.batch_at(step).items()}


def _params(model):
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def test_loss_decreases(tiny_setup):
    _, opt, data, fresh = tiny_setup
    model, opt_state = fresh()
    step_fn = make_train_step(model, opt)
    losses = []
    for step in range(30):
        model, opt_state, metrics = step_fn(model, opt_state, _batch(data, step))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[:3] + losses[-3:]
    assert np.isfinite(losses).all()


def test_data_is_the_references(tiny_setup):
    cfg, _, data, _ = tiny_setup
    j_data = JSyntheticLM(data.cfg)
    for step in (0, 5):
        assert (data.batch_at(step)["tokens"] == j_data.batch_at(step)["tokens"]).all()


def test_grad_accumulation_matches_full_batch(tiny_setup):
    _, opt, data, fresh = tiny_setup
    batch = _batch(data, 0)
    m1, s1 = fresh()
    m4, s4 = fresh()
    make_train_step(m1, opt)(m1, s1, batch)
    make_train_step(m4, opt, microbatches=4)(m4, s4, batch)
    p1, p4 = _params(m1), _params(m4)
    assert max(float((p1[k].float() - p4[k].float()).abs().max()) for k in p1) < 5e-2


def test_remat_matches(tiny_setup):
    _, opt, data, fresh = tiny_setup
    batch = _batch(data, 1)
    ma, sa = fresh()
    mb, sb = fresh()
    a = make_train_step(ma, opt)(ma, sa, batch)[2]
    b = make_train_step(mb, opt, remat=True)(mb, sb, batch)[2]
    assert abs(float(a["loss"]) - float(b["loss"])) < 1e-5


def test_bf16_compression_close(tiny_setup):
    _, opt, data, fresh = tiny_setup
    batch = _batch(data, 2)
    ma, sa = fresh()
    mb, sb = fresh()
    make_train_step(ma, opt)(ma, sa, batch)
    make_train_step(mb, opt, compress=compress_bf16)(mb, sb, batch)
    pa, pb = _params(ma), _params(mb)
    assert max(float((pa[k].float() - pb[k].float()).abs().max()) for k in pa) < 1e-2


def test_step_refuses_another_model(tiny_setup):
    _, opt, data, fresh = tiny_setup
    ma, sa = fresh()
    mb, _ = fresh()
    with pytest.raises(ValueError, match="the model it was made for"):
        make_train_step(ma, opt)(mb, sa, _batch(data, 0))


def test_adamw_pieces_change_no_value(monkeypatch):
    """The update cuts large leaves into flat pieces (bounded float32
    temporaries); every op is elementwise, so the pieces change no bit."""
    from repro_torch.training import optimizer as O

    gen = torch.Generator().manual_seed(0)
    shapes = {"a": ((5, 3), torch.float32), "b": ((4,), torch.bfloat16),
              "c": ((9,), torch.float32)}
    init = {k: torch.randn(s, generator=gen).to(dt) for k, (s, dt) in shapes.items()}
    grads = {k: torch.randn(v.shape, generator=gen).to(v.dtype) for k, v in init.items()}
    out = {}
    for elems in (7, O.GROUP_ELEMS):
        monkeypatch.setattr(O, "GROUP_ELEMS", elems)
        params = {k: torch.nn.Parameter(v.clone()) for k, v in init.items()}
        opt = adamw(0.01)
        state = opt.init(params)
        for _ in range(2):
            _, state, met = opt.update(grads, state, params)
        out[elems] = (params, state, met)
    (p1, s1, m1), (p2, s2, m2) = out.values()
    assert len(O._groups(list(init), p1)) == 3      # (a), (b), (c) at full size
    for k in init:
        assert torch.equal(p1[k], p2[k]) and torch.equal(s1["mu"][k], s2["mu"][k])
        assert torch.equal(s1["nu"][k], s2["nu"][k])
    torch.testing.assert_close(m1["grad_norm"], m2["grad_norm"], rtol=1e-6, atol=0)
