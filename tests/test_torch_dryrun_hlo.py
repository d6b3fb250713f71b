"""The port's HLO text parsers (``repro_torch.launch.hlo_stats._shape_bytes``
and ``collective_bytes``): twins of ``tests/test_hlo_stats.py``'s synthetic
cases, each also giving the reference's answer.  (The text of the program
that ``test_collective_parse_real_program`` lowers is checked in
``test_torch_dryrun_ref.py``: only its subprocess lowers.)  Exact."""
import pytest

pytest.importorskip("torch")

from repro.launch import hlo_stats as J  # noqa: E402
from repro_torch.launch.hlo_stats import _shape_bytes, collective_bytes  # noqa: E402

SHAPES = [
    ("bf16[8,128]{1,0}", 8 * 128 * 2),
    ("f32[100]", 400),
    ("(f32[4], s8[16])", 16 + 16),
    ("pred[]", 1),
    ("token[]", 0),
    ("(s32[2,3], u16[5]{0}, f8e4m3fn[7])", 24 + 10 + 7),
]

SYNTHETIC = """
HloModule m
  %ar = bf16[1024,8]{1,0} all-reduce(%x), replica_groups={}
  %ag = f32[64]{0} all-gather(%y), dimensions={0}
  %rs = f32[32]{0} reduce-scatter(%z), dimensions={0}
  %a2a = (s8[16], s8[16]) all-to-all(%p, %q)
  %cp = u32[128]{0} collective-permute(%w), source_target_pairs={{0,1}}
  %cps = u32[128]{0} collective-permute-start(%w)
  %add = f32[2] add(%a, %b)
"""


@pytest.mark.parametrize("text,nbytes", SHAPES)
def test_shape_bytes(text, nbytes):
    assert _shape_bytes(text) == nbytes == J._shape_bytes(text)


def test_collective_parse_synthetic():
    out = collective_bytes(SYNTHETIC)
    assert out["all-reduce"] == 1024 * 8 * 2
    assert out["all-gather"] == 256
    assert out["reduce-scatter"] == 128
    assert out["all-to-all"] == 32
    # -start counted once, plain counted once
    assert out["collective-permute"] == 2 * 128 * 4
    assert out["_counts"]["all-reduce"] == 1
    assert out == J.collective_bytes(SYNTHETIC)
