"""The port's dry run against the reference's compiled steps, on reduced
cells at a (2, 2) data/model mesh: the dense config's train, prefill and
decode, and its ``zero1``, ``kv_quant`` and ``kv_layout="seq"`` variants;
one ``qbs-label`` cell per exchange mode, one ``qbs-serve`` and one
``qbs-scale-serve`` cell, at a 1,000-vertex graph the helper adds to the
reference's ``GRAPHS`` in memory; and the HLO text of
``tests/test_hlo_stats.py``'s real program, which the port's
``collective_bytes`` and ``_shape_bytes`` must read as the reference's do.  (The MoE, recurrent and hybrid
configs' cells are in ``test_torch_dryrun_ref_families.py``.)

The reference side runs in a process of its own
(``tests/helpers/dryrun_ref_check.py``): importing ``repro.launch.dryrun``
sets ``XLA_FLAGS`` to 512 host devices.  Held exactly:

* the port's per-device ``argument_bytes`` equals XLA's
  ``argument_size_in_bytes`` of the compiled step;
* every spec the reference lays the step out with (parameters, moments,
  batch, cache) equals the port's, the layer-stack dims dropped where the
  port holds the layers as list entries.
"""
import pytest

torch = pytest.importorskip("torch")

from helpers.torch_dryrun import (  # noqa: E402
    check_lm_argument_bytes,
    check_lm_specs,
    mesh22,
    port_cell,
    port_qbs_cell,
    run_reference,
)
from repro.launch import hlo_stats as J  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.hlo_stats import _shape_bytes, collective_bytes  # noqa: E402
from repro_torch.models.config import ShapeCell  # noqa: E402

DENSE = ["dense-train", "dense-prefill", "dense-decode", "dense-train-zero1",
         "dense-decode-kvq", "dense-decode-kvseq"]
QBS = ["qbs-label-bool", "qbs-label-bitmap", "qbs-label-pull", "qbs-serve",
       "qbs-scale-serve"]


@pytest.fixture(scope="module")
def ref():
    return run_reference("dense,qbs,hlo")


@pytest.mark.parametrize("name", DENSE)
def test_lm_argument_bytes_equal_reference(ref, name):
    check_lm_argument_bytes(ref["lm"][name])


@pytest.mark.parametrize("name", DENSE)
def test_lm_specs_equal_reference(ref, name):
    check_lm_specs(ref["lm"][name])


def test_zero1_cuts_the_layer_stack(ref):
    """At two layers and dp = 2 the reference's zero1 cuts the block
    moments' layer-stack dim: the port's specs spell it."""
    cfg, _ = port_cell(ref["lm"]["dense-train-zero1"])
    lay = D.lm_layout(cfg, ShapeCell("t", "train", 64, 4), mesh22(), zero1=True)
    cut = [n for n, s in lay["mom_spec"].items() if len(s) > lay["params"][n].dim()]
    assert cut and all(n.startswith("blocks.") for n in cut)


@pytest.mark.parametrize("name", QBS)
def test_qbs_argument_bytes_equal_reference(ref, name):
    case = ref["qbs"][name]
    got = port_qbs_cell(ref, case)
    assert got["graph"] == case["graph"]
    assert got["memory"]["argument_bytes"] == case["argument_bytes"]


def test_collective_parse_real_program(ref):
    """A psum under shard_map shows up as all-reduce bytes, read the same by
    both packages' parsers, line by line."""
    text = ref["hlo_text"]
    out = collective_bytes(text)
    assert out == J.collective_bytes(text)
    assert out.get("all-reduce", 0) >= 256 * 4
    for line in text.splitlines():
        if " = " in line:
            ty = line.split(" = ", 1)[1].split(" ", 1)[0]
            assert _shape_bytes(ty) == J._shape_bytes(ty)
