"""The port's dry run against the reference's compiled steps on the MoE
(phi3.5-moe), recurrent (rwkv6) and hybrid (zamba2) configs' reduced
cells at a (2, 2) data/model mesh: train, prefill and decode, and the
batch-1 sequence-parallel decode fallback (``_sp_cache_pspecs``), which
the ``long_500k`` shape takes.  ``argument_bytes`` and every spec held
exactly, as in ``test_torch_dryrun_ref.py`` (which holds the dense config
and the QbS cells)."""
import pytest

torch = pytest.importorskip("torch")

from helpers.torch_dryrun import (  # noqa: E402
    check_lm_argument_bytes,
    check_lm_specs,
    run_reference,
)

FAMILIES = ["moe-train", "moe-prefill", "moe-decode", "ssm-train", "ssm-prefill",
            "ssm-decode", "ssm-decode-b1", "hybrid-decode-b1"]


@pytest.fixture(scope="module")
def ref():
    return run_reference("families")


@pytest.mark.parametrize("name", FAMILIES)
def test_lm_argument_bytes_equal_reference(ref, name):
    check_lm_argument_bytes(ref["lm"][name])


@pytest.mark.parametrize("name", FAMILIES)
def test_lm_specs_equal_reference(ref, name):
    check_lm_specs(ref["lm"][name])
