"""The port's example scripts run on the CPU (``--device cpu``), each in a
subprocess where importing ``jax`` or the JAX package fails, so they show
the port standing alone.  The quickstart prints exactly what the
reference's ``examples/quickstart.py`` prints."""
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


def _run(script: str, *args: str, block_jax: bool = True) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    cmd = [sys.executable, "-c", RUNNER, str(ROOT / "examples" / script), *args] \
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


def test_examples_need_a_card_unless_told():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(ROOT / "examples" / "torch_quickstart.py")],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "no CUDA device available" in out.stderr
