"""The dry run's meta-device cost trace (``repro_torch.launch.hlo_stats.
CostCounter`` over ``repro_torch.launch.dryrun.trace_step``):

* its FLOPs equal ``torch.utils.flop_counter.FlopCounterMode`` over the
  same step run for real on the CPU, on every family's reduced config
  (train; prefill and decode where the family has them; layer remat and
  microbatches);
* they equal a matmul count written out below for the dense config;
* FLOPs, transcendentals and bytes are exactly linear in ``n_layers`` at
  three depths, the assumption behind the reference's depth extrapolation
  (the port traces every layer, so it needs none);
* the counter's bytes are each op's operands plus results, and views
  count none;
* at full size (``qwen1.5-4b``, ``deepseek-7b``) the count equals
  ``_param_count`` x 6 per token (train) or x 2 (prefill) plus the
  attention products, with zero tolerance.  That is exact for a dense
  decoder: its only matmuls are the seven weight products of each layer,
  the head and the two attention products (QK^T and AV over the full
  (S, S) square, which the naive attention computes); biases, norms and
  RoPE are elementwise, and the embedding is a gather.  ``_param_count``
  holds the embedding and the head, so one V x d is taken off for the
  gather, and prefill computes the head at the last position only.

All exact (integers)."""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.models import SHAPES, build_model  # noqa: E402
from repro_torch.models.config import ShapeCell  # noqa: E402
from repro_torch.models.transformer import init_decode_cache  # noqa: E402
from repro_torch.serving.serve_step import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.training import adamw, make_train_step, warmup_cosine  # noqa: E402

B, S = 2, 64
FAMILY_CASES = [  # (arch, kinds)
    ("qwen1.5-4b", ("train", "prefill", "decode")),
    ("phi3.5-moe-42b-a6.6b", ("train", "prefill", "decode")),
    ("dbrx-132b", ("train",)),
    ("rwkv6-1.6b", ("train", "prefill", "decode")),
    ("zamba2-2.7b", ("train", "prefill", "decode")),
    ("hubert-xlarge", ("train", "prefill")),
    ("internvl2-76b", ("train", "decode")),
    ("deepseek-7b", ("train",)),
]


def _shape(cfg, kind, b=B, s=S):
    if cfg.frontend == "vision_patches" and kind != "decode":
        s = 256 + 16       # the patch prefix plus 16 tokens
    return ShapeCell("cell", kind, s, b)


def real_flops(cfg, shape, microbatches=1):
    """FlopCounterMode over one step of real tensors on the CPU."""
    g = torch.Generator().manual_seed(0)
    model = build_model(cfg, device="cpu", generator=g)
    rng = np.random.default_rng(0)
    b, s = shape.global_batch, shape.seq_len

    def toks(*shp):
        return torch.from_numpy(rng.integers(0, cfg.vocab_size, shp).astype(np.int32))

    if shape.kind == "decode":
        cache = init_decode_cache(cfg, b, s, device="cpu")
        step = make_decode_step(model)
        with FlopCounterMode(display=False) as fc:
            step(cache, s - 1, toks(b, 1))
        return fc.get_total_flops()
    if cfg.frontend == "audio_frames":
        batch = {"features": torch.randn(b, s, cfg.frontend_dim, generator=g),
                 "targets": toks(b, s), "loss_mask": torch.ones(b, s, dtype=torch.bool)}
    elif cfg.frontend == "vision_patches":
        batch = {"patches": torch.randn(b, 256, cfg.frontend_dim, generator=g),
                 "tokens": toks(b, s - 256)}
    else:
        batch = {"tokens": toks(b, s)}
    with FlopCounterMode(display=False) as fc:
        if shape.kind == "train":
            opt = adamw(warmup_cosine(3e-4, 2000, 100_000))
            state = opt.init(dict(model.named_parameters()))
            make_train_step(model, opt, microbatches=microbatches)(model, state, batch)
        else:
            make_prefill_step(model)(batch)
    return fc.get_total_flops()


@pytest.mark.parametrize("arch,kind", [(a, k) for a, ks in FAMILY_CASES for k in ks])
def test_meta_trace_equals_real_cpu_step(arch, kind):
    cfg = get_config(arch).reduced(dtype="float32")
    shape = _shape(cfg, kind)
    got = D.trace_step(cfg, shape)["flops"]
    assert got > 0
    assert got == real_flops(cfg, shape)


@pytest.mark.parametrize("variant", ["remat", "microbatches"])
def test_meta_trace_equals_real_cpu_step_variants(variant):
    cfg = get_config("qwen1.5-4b").reduced(dtype="float32")
    mb = 2 if variant == "microbatches" else 1
    if variant == "remat":
        cfg = replace(cfg, remat_policy="layer")
    shape = _shape(cfg, "train", b=4)
    got = D.trace_step(cfg, shape, microbatches=mb)["flops"]
    assert got == real_flops(cfg, shape, microbatches=mb)
    if variant == "remat":   # the layers' forwards run twice
        plain = D.trace_step(replace(cfg, remat_policy="none"), shape)["flops"]
        assert got > plain


def dense_matmul_flops(cfg, kind: str, b: int, s: int) -> int:
    """FLOPs of one dense step by hand: 2 per multiply-add."""
    d, f, v, hd = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.hd
    h, hkv, n = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    rows = b * (1 if kind == "decode" else s)
    proj = d * h * hd + 2 * d * hkv * hd + h * hd * d + 3 * d * f
    keys = s                              # decode attends over the whole cache
    attn = 2 * 2 * b * h * (1 if kind == "decode" else s) * keys * hd
    head_rows = b if kind == "prefill" else rows
    fwd = n * (2 * rows * proj + attn) + 2 * head_rows * d * v
    return 3 * fwd if kind == "train" else fwd


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_meta_trace_equals_hand_count(kind):
    cfg = get_config("qwen1.5-4b").reduced()
    shape = ShapeCell("cell", kind, S, B)
    assert D.trace_step(cfg, shape)["flops"] == dense_matmul_flops(cfg, kind, B, S)


@pytest.mark.parametrize("arch,kind", [
    ("qwen1.5-4b", "train"), ("qwen1.5-4b", "decode"), ("rwkv6-1.6b", "prefill"),
    ("zamba2-2.7b", "train"), ("phi3.5-moe-42b-a6.6b", "prefill")])
def test_cost_is_linear_in_depth(arch, kind):
    base = get_config(arch).reduced()
    per = base.hybrid_period or 1
    got = [D.trace_step(replace(base, n_layers=k * per), ShapeCell("c", kind, S, B))
           for k in (1, 2, 3)]
    for key in ("flops", "transcendentals", "bytes_accessed"):
        a, b_, c = (x[key] for x in got)
        assert c - b_ == b_ - a > 0, key


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "deepseek-7b"])
@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k"])
def test_full_size_count_equals_param_count(arch, shape_name):
    cfg, shape = get_config(arch), SHAPES[shape_name]
    b, s = shape.global_batch, shape.seq_len
    n, _ = D._param_count(cfg)
    v_d = cfg.vocab_size * cfg.d_model
    attn = 4 * b * cfg.n_heads * s * s * cfg.hd * cfg.n_layers
    if shape.kind == "train":
        want = 6 * b * s * (n - v_d) + 3 * attn
    else:
        want = 2 * b * s * (n - 2 * v_d) + 2 * b * v_d + attn
    got = D.trace_step(cfg, shape)["flops"]
    assert got == want


def test_counter_bytes_skip_views():
    from repro_torch.launch.hlo_stats import CostCounter

    x = torch.empty(8, 16, device="meta")
    w = torch.empty(16, 4, device="meta")
    with CostCounter() as views:
        x.view(16, 8).t().expand(2, 8, 16).detach()[:, 1:]
    assert views.bytes_accessed == 0 and views.n_ops > 0
    with CostCounter() as c:
        y = x + x
        z = x @ w
    assert c.bytes_accessed == 3 * y.nbytes + x.nbytes + w.nbytes + z.nbytes
