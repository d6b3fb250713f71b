"""The recover search's side attach behind the kernel seam
(``kernels.ops.side_attach``), on the CPU.

On the CPU the seam takes the plain version (``ref.side_attach_ref``), held
here to the reference's ``_side_attach`` on the same depth tables: the edge
mask and the certified set ``on`` (unpacked from the kernels' words), at
widths that cross a 32-row word (B' = 1, 33, 70), with the closure cut at
one step and left to run.  The CUDA kernels cannot run here, so a PyTorch
model of them (``helpers.side_attach_cases.kernel_model``: packed labels,
words, closure segments, the decrement tested from the label rows) is held
to the plain version on real and on arbitrary inputs, near the packed
dtype's sentinel too.  Then the argument checks, the closure's warp
schedule, and an index on the CPU, whose plain attach builds its edge lists
at its first call.  Every comparison is exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from helpers import side_attach_cases as cases  # noqa: E402
from helpers.serving_oracle import assert_bit_identical  # noqa: E402

from repro.core import graph as jg  # noqa: E402
from repro.core import search as js  # noqa: E402
from repro.core.labelling import build_labelling as j_build  # noqa: E402
from repro_torch.core import QbSIndex  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core.search import LandmarkEdges  # noqa: E402
from repro_torch.kernels import attach, ops, ref  # noqa: E402

WIDTHS = (1, 33, 70)


@pytest.fixture(scope="module")
def reference_ctx():
    """The reference's search context on ``cases.real``'s graph."""
    g = jg.barabasi_albert_graph(150, 2, seed=3)
    return js.make_search_context(g, j_build(g, jg.select_landmarks(g, 6)))


@pytest.mark.parametrize("max_chain", [1, 64])
@pytest.mark.parametrize("b", WIDTHS)
def test_seam_matches_reference(reference_ctx, b, max_chain):
    a = cases.real(b, max_levels=1)
    v = a["depth"].shape[1]
    want_e, want_on = jax.vmap(lambda d, s: js._side_attach(
        reference_ctx, d, s, v, max_chain))(jnp.asarray(a["depth"].numpy()),
                                            jnp.asarray(a["side_land"].numpy()))
    count = ops.LAUNCHES["side_attach"]
    got_e, got_on = ops.side_attach(**a, max_chain=max_chain)
    assert ops.LAUNCHES["side_attach"] == count      # the plain version
    assert np.array_equal(np.asarray(want_e), got_e.numpy())
    assert got_on.shape == (v, (b + 31) // 32, a["label_dist"].shape[1])
    assert np.array_equal(np.asarray(want_on),
                          ref.unpack_on(got_on, b).permute(1, 2, 0).numpy())
    prev = torch.from_numpy(np.random.default_rng(b).random(got_e.shape) < 0.1)
    out = prev.clone()
    again, _ = ops.side_attach(**a, max_chain=max_chain, out=out)
    assert again is out and torch.equal(out, prev | got_e)


def test_closure_cut_matters():
    """At B' = 33 the closure takes more than one step, so ``max_chain`` 1
    cuts chains that the default lets grow."""
    a = cases.real(33, max_levels=1)
    one, on_one = ops.side_attach(**a, max_chain=1)
    full, on_full = ops.side_attach(**a, max_chain=64)
    assert not torch.equal(on_one, on_full) and not torch.equal(one, full)


MODEL_CASES = [(maker, kw, b, mc)
               for maker, kw in (("real", {"max_levels": 1}),
                                 ("real", {"max_levels": 2, "dtype": torch.uint16}),
                                 ("synthetic", {"seed": 1}),
                                 ("synthetic", {"seed": 2, "near_sentinel": True}),
                                 ("synthetic", {"seed": 3, "dtype": torch.uint16,
                                                "near_sentinel": True}))
               for b in WIDTHS for mc in (1, 64)]


@pytest.mark.parametrize("maker,kw,b,max_chain", MODEL_CASES)
def test_kernel_model_matches_plain(maker, kw, b, max_chain):
    a = getattr(cases, maker)(b=b, **kw)
    want_e, want_on = ref.side_attach_ref(**a, max_chain=max_chain)
    got_e, got_on, steps = cases.kernel_model(**a, max_chain=max_chain)
    assert 1 <= steps <= max_chain
    assert torch.equal(got_on, want_on) and torch.equal(got_e, want_e)


def _bad(name):
    a = cases.synthetic(0, 5)
    e = a["src"].shape[0]
    swap = {"depth int64": ("depth", a["depth"].long()),
            "labels int32": ("label_dist", a["label_dist"].int()),
            "labels 1-D": ("label_dist", a["label_dist"][:, 0]),
            "sigma width": ("side_land", a["side_land"][:, :-1]),
            "sigma int64": ("side_land", a["side_land"].long()),
            "indptr length": ("indptr", a["indptr"][:-1]),
            "dst length": ("dst", a["dst"][:-1]),
            "lid int64": ("lid", a["lid"].long()),
            "out shape": ("out", torch.zeros((5, e - 1), dtype=torch.bool)),
            "out dtype": ("out", torch.zeros((5, e), dtype=torch.uint8))}
    if name in swap:
        key, val = swap[name]
        a[key] = val
    return a


@pytest.mark.parametrize("name", ["depth int64", "labels int32", "labels 1-D",
                                  "sigma width", "sigma int64", "indptr length",
                                  "dst length", "lid int64", "out shape",
                                  "out dtype"])
def test_check_side_attach_args_raises(name):
    a = _bad(name)
    with pytest.raises(ValueError):
        attach.check_side_attach_args(**a, max_chain=4)
    with pytest.raises(ValueError):
        ops.side_attach(**a, max_chain=4)


def test_side_attach_refuses_devices_and_chain():
    a = _bad(None)
    with pytest.raises(ValueError, match="max_chain"):
        ops.side_attach(**a, max_chain=-1)
    with pytest.raises(ValueError, match="mixed or unsupported"):
        ops.side_attach(**{**a, "lid": a["lid"].to("meta")}, max_chain=4)
    with pytest.raises(ValueError, match="one CUDA device"):
        attach.side_attach_cuda(**a, max_chain=4)   # CPU tensors, before any build


def test_closure_segments_cover_every_slot():
    g = cases.synthetic(0, 1)
    indptr = g["indptr"]
    rows, beg = attach.closure_segments(indptr)
    assert rows.dtype == beg.dtype == torch.int32
    seen = torch.zeros(int(indptr[-1]), dtype=torch.int64)
    for y, s in zip(rows.tolist(), beg.tolist()):
        end = min(s + attach.SEG_SLOTS, int(indptr[y + 1]))
        assert int(indptr[y]) <= s < end
        seen[s:end] += 1
    assert bool((seen == 1).all())
    assert int(indptr.diff().max()) > 2 * attach.SEG_SLOTS   # a row split 3 ways
    assert attach.cached_segments(indptr)[0] is attach.cached_segments(indptr)[0]


def test_cpu_index_builds_attach_lists_lazily():
    """The context keeps only the Delta stage's lists; the plain attach
    builds its decrement lists at its first call, once per label table, and
    the index answers as the oracle does."""
    assert LandmarkEdges._fields == ("at_src", "at_dst", "ll")
    g = tg.barabasi_albert_graph(120, 2, seed=7, device="cpu")
    idx = QbSIndex.build(g, n_landmarks=5, device="cpu")
    key = id(idx.ctx.label_dist)
    assert key not in ref._ATTACH_LISTS
    rng = np.random.default_rng(7)
    us = rng.integers(0, 120, 40).astype(np.int32)
    vs = rng.integers(0, 120, 40).astype(np.int32)
    res = idx.query_batch(us, vs)
    lists = ref._ATTACH_LISTS[key]
    assert lists[0] is idx.ctx.src and len(lists[3][0]) == 5
    assert_bit_identical(g, res, us, vs)
    idx.query_batch(us[:8], vs[:8])
    assert ref._ATTACH_LISTS[key] is lists
