"""The port's example scripts and its train CLI run on the CPU (``--device
cpu``), each in a subprocess where importing ``jax`` or the JAX package
fails, so they show the port standing alone.  The quickstart prints
exactly what the reference's ``examples/quickstart.py`` prints."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
# run an example as __main__ with jax and the JAX package unimportable
RUNNER = ("import runpy, sys; sys.modules['jax'] = None; sys.modules['repro'] = None; "
          "path = sys.argv[1]; sys.argv = sys.argv[1:]; "
          "runpy.run_path(path, run_name='__main__')")
# the same for a module (``python -m``)
MODULE_RUNNER = RUNNER.replace("run_path(path", "run_module(path")


def _run(script: str, *args: str, block_jax: bool = True, tmp=None) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    if tmp is not None:
        env["TMPDIR"] = str(tmp)
    if script.endswith(".py"):
        target = [RUNNER, str(ROOT / "examples" / script)]
    else:
        target = [MODULE_RUNNER, script]
    cmd = [sys.executable, "-c", *target, *args] \
        if block_jax else [sys.executable, str(ROOT / "examples" / script), *args]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_quickstart_prints_the_references_output():
    got = _run("torch_quickstart.py", "--device", "cpu")
    assert "matches the two-BFS oracle: OK" in got
    assert got == _run("quickstart.py", block_jax=False)


def test_qbs_query_demo():
    got = _run("torch_qbs_query_demo.py", "--device", "cpu")
    assert got.count("oracle:OK") == 3 and "MISMATCH" not in got
    assert "cache hits=64" in got
    assert "64 queries in" in got


def test_serve_decode():
    got = _run("torch_serve_decode.py", "--device", "cpu")
    assert "bf16 KV: (4, 16)" in got and "int8 KV: (4, 16)" in got
    assert "greedy-token agreement bf16 vs int8 KV:" in got


def test_train_lm(tmp_path):
    got = _run("torch_train_lm.py", "--device", "cpu", "--steps", "100", tmp=tmp_path)
    assert "on cpu" in got
    losses = [float(line.split("loss=")[1].split()[0]) for line in got.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 5 and losses[-1] < losses[0] - 0.5, losses
    assert "restore check: step 100 OK" in got


def _ckpt_params(step_dir):
    import json

    import numpy as np
    keys = json.loads((step_dir / "manifest.json").read_text())["keys"]
    return {k: np.load(step_dir / f"arr_{i:05d}.npy") for i, k in enumerate(keys)}


def test_train_cli_and_resume(tmp_path):
    """``python -m repro_torch.launch.train``: 12 steps with checkpoints at
    6 and 12; then a run that finds only step 6 (a preempted job) resumes
    there and ends bit-identical to the first."""
    import numpy as np
    args = ["--arch", "qwen1.5-4b", "--reduced", "--steps", "12", "--ckpt-every", "6",
            "--log-every", "3", "--device", "cpu"]
    first = _run("repro_torch.launch.train", *args, "--ckpt-dir", str(tmp_path / "a"))
    lines = first.splitlines()
    assert lines[0].startswith("[train] arch=qwen1.5-4b params=") and "device=cpu" in lines[0]
    steps = [int(ln.split()[2]) for ln in lines if ln.startswith("[train] step ")]
    assert steps == [1, 3, 6, 9, 12] and lines[-1] == "[train] done"
    for ln in lines[1:-1]:
        assert "loss=" in ln and "gnorm=" in ln and "lr=" in ln and "ms/step" in ln
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == \
        ["LATEST", "step_0000000006", "step_0000000012"]

    (tmp_path / "b").mkdir()
    (tmp_path / "a" / "step_0000000006").rename(tmp_path / "b" / "step_0000000006")
    (tmp_path / "b" / "LATEST").write_text("step_0000000006")
    second = _run("repro_torch.launch.train", *args, "--ckpt-dir", str(tmp_path / "b"),
                  "--resume")
    assert "[train] resumed from step 6" in second
    assert [int(ln.split()[2]) for ln in second.splitlines()
            if ln.startswith("[train] step ")] == [7, 9, 12]
    want = _ckpt_params(tmp_path / "a" / "step_0000000012")
    got = _ckpt_params(tmp_path / "b" / "step_0000000012")
    assert sorted(want) == sorted(got)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_examples_need_a_card_unless_told():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(ROOT / "examples" / "torch_quickstart.py")],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "no CUDA device available" in out.stderr


@pytest.mark.parametrize("cmd", [
    ["examples/torch_train_lm.py", "--steps", "1"],
    ["-m", "repro_torch.launch.train", "--arch", "qwen1.5-4b", "--reduced", "--steps", "1"],
])
def test_train_entry_points_need_a_card_unless_told(cmd):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, *cmd], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "no CUDA device available" in out.stderr
