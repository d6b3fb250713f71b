"""The port's dry-run CLI (``python -m repro_torch.launch.dryrun``), run in
process on one LM cell and on every QbS cell, into a results
directory passed with ``--results``: the cells' names and skip rules are
the reference's, a cell that raises is recorded and the run goes on, and
every reported field has its stated meaning.  The variant flags that no
reference check covers (``moe_sort``, ``moe_group``, ``flash``,
``seq_shard``, ``kv_layout="rep"``) trace on reduced cells."""
import json
from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.mesh import NamedMesh  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.models import SHAPES, ShapeCell, cell_applicable  # noqa: E402


def test_cli_lm_cell(tmp_path, capsys):
    rc = D.main(["--cells", "lm", "--arch", "qwen1.5-4b", "--shape", "decode_32k",
                 "--mesh", "single", "--results", str(tmp_path)])
    assert rc == 0
    assert "ok=1 skipped=0 failures=0" in capsys.readouterr().out
    (path,) = tmp_path.iterdir()
    assert path.name == "lm__qwen1.5-4b__decode_32k__single.json"
    cell = json.loads(path.read_text())
    assert cell["n_devices"] == 256
    for key in ("flops", "bytes_accessed", "transcendentals"):
        assert cell[key] == cell[f"{key}_global"] / 256
    assert cell["flops_global"] > 0 and cell["memory"]["argument_bytes"] > 0
    assert cell["memory"]["temp_bytes"] is None
    assert cell["compile_s"] is None and cell["n_hlo_lines"] is None
    assert set(cell["why"]) == {"temp_bytes", "compile_s", "n_hlo_lines"}
    assert "depth_extrapolated" not in cell
    assert cell["collectives"]["all-reduce"] > 0
    # a recorded cell is read back, not traced again
    assert D.run_cell("lm", "qwen1.5-4b", "decode_32k", "single",
                      results=tmp_path)[1] == cell


def test_cli_qbs_cells(tmp_path, capsys):
    rc = D.main(["--cells", "qbs", "--mesh", "both", "--qbs-frontier", "pull",
                 "--results", str(tmp_path)])
    assert rc == 0
    assert "ok=24 skipped=0 failures=0" in capsys.readouterr().out
    names = sorted(p.name for p in tmp_path.iterdir())
    assert len(names) == 24
    assert [n for n in names if "__twitter__" in n] == [
        f"{k}__twitter__{s}__{m}{t}.json"
        for k, s, t in (("qbs-label", "label", "__pull"),
                        ("qbs-scale-serve", "serve", ""))
        for m in ("multi", "single")]
    cell = json.loads((tmp_path / "qbs-label__twitter__label__multi__pull.json").read_text())
    assert cell["graph"] == {"V": 41_700_000, "E_directed": 2_400_000_000, "R": 20}
    assert cell["n_devices"] == 512 and cell["flops"] is None and cell["why"]["flops"]
    assert set(cell["collectives"]) == {"all-to-all", "all-reduce", "_counts"}


def test_cli_skips_and_records_failures(tmp_path, capsys):
    rc = D.main(["--cells", "lm", "--arch", "hubert-xlarge", "--mesh", "multi",
                 "--results", str(tmp_path)])
    assert rc == 0
    cfg = get_config("hubert-xlarge")
    for name, shape in SHAPES.items():
        cell = json.loads((tmp_path / f"lm__hubert-xlarge__{name}__multi.json").read_text())
        ok, why = cell_applicable(cfg, shape)
        assert ("skipped" not in cell) == ok
        if not ok:
            assert cell["skipped"] == why
    rc = D.main(["--cells", "lm", "--arch", "no-such-arch", "--shape", "train_4k",
                 "--mesh", "single", "--results", str(tmp_path)])
    assert rc == 1
    assert "failures=1" in capsys.readouterr().out
    cell = json.loads((tmp_path / "lm__no-such-arch__train_4k__single.json").read_text())
    assert "no-such-arch" in cell["error"] and cell["traceback"]


VARIANTS = [  # (arch, kind, seq, variant); 2,048 tokens make two MoE groups
    ("phi3.5-moe-42b-a6.6b", "train", 512, {"moe_sort": True}),
    ("phi3.5-moe-42b-a6.6b", "train", 512, {"moe_group": True}),
    ("qwen1.5-4b", "prefill", 64, {"flash": True}),
    ("qwen1.5-4b", "train", 64, {"seq_shard": "sp"}),
    ("qwen1.5-4b", "train", 64, {"seq_shard": "dp"}),
    ("qwen1.5-4b", "decode", 64, {"kv_layout": "rep"}),
]


@pytest.mark.parametrize("arch,kind,seq,variant", VARIANTS, ids=str)
def test_variant_cells(arch, kind, seq, variant):
    """The flags no reference check covers trace on a reduced config at a
    (2, 2) mesh: a variant that changes only the computation keeps the
    plain cell's argument bytes; chunked attention computes the same
    products as the naive one; the MoE dispatches change the count;
    Megatron-SP turns each tensor-parallel all-reduce into a reduce-scatter
    (1/tp of it) and an all-gather, and leaves the DP reduce alone."""
    cfg = replace(get_config(arch).reduced(), attn_chunk=16)
    shape = ShapeCell("cell", kind, seq, 4)
    mesh = NamedMesh(["meta"] * 4, ("data", "model"), (2, 2))
    plain = D.lm_cell(cfg, shape, mesh)
    got = D.lm_cell(cfg, shape, mesh, **variant)
    assert got["variant"] == {**plain["variant"], **variant}
    if "kv_layout" in variant:    # the cache replicated over model
        assert got["memory"]["argument_bytes"] > plain["memory"]["argument_bytes"]
    else:
        assert got["memory"]["argument_bytes"] == plain["memory"]["argument_bytes"]
    if "flash" in variant:
        assert got["flops_global"] == plain["flops_global"]
    if "moe_sort" in variant or "moe_group" in variant:
        assert got["flops_global"] < plain["flops_global"]
    coll, base = got["collectives"], plain["collectives"]
    if variant.get("seq_shard") == "sp":
        assert coll["all-gather"] == base["all-reduce"] - coll["all-reduce"] > 0
        assert 2 * coll["reduce-scatter"] == coll["all-gather"]
    elif variant.get("seq_shard") == "dp":
        assert coll == base
