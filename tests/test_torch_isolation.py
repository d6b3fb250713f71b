"""The port stands alone: no module of ``src/repro_torch/`` and not
``chip_smoke.py`` imports JAX or the JAX package ``repro``; the package
imports, builds and answers with JAX blocked; and every entry point defaults
to the CUDA card and raises without one instead of running on the CPU.
Checks are exact (set equality of imports, equality of answers)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_port_runs_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "from repro_torch.core import QbSIndex, gnp_random_graph\n"
        "import repro_torch, repro_torch.convert, repro_torch.serving\n"
        "g = gnp_random_graph(30, 3.0, seed=2, device='cpu')\n"
        "idx = QbSIndex.build(g, n_landmarks=3, chunk=8, device='cpu')\n"
        "r = idx.query(1, 17)\n"
        "print(r.dist, len(r.edge_ids))\n"
        "assert not any(m.startswith('jax') for m in sys.modules if sys.modules[m])\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    d, n = map(int, out.stdout.split())
    sys.path.insert(0, str(ROOT / "tests"))
    from helpers.serving_oracle import oracle_spg
    from repro_torch.core import gnp_random_graph

    want_d, want_eids = oracle_spg(gnp_random_graph(30, 3.0, seed=2, device="cpu"),
                                   1, 17)
    assert (d, n) == (want_d, want_eids.size)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from repro_torch.convert import graph_from_numpy, index_from_numpy
    from repro_torch.core import QbSIndex, build_labelling, from_edges, gnp_random_graph
    from repro_torch.core import baselines
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = gnp_random_graph(20, 3.0, seed=1, device="cpu")
    arrays = [t.numpy() for t in g]
    for call in (lambda: gnp_random_graph(20, 3.0, seed=1),
                 lambda: from_edges(np.array([[0, 1]]), 2),
                 lambda: build_labelling(g, np.array([0, 1], np.int32)),
                 lambda: QbSIndex.build(g, n_landmarks=2),
                 lambda: graph_from_numpy(*arrays),
                 lambda: index_from_numpy(arrays, [None] * 6),
                 lambda: baselines.bfs_distances(g, 0),
                 lambda: baselines.bfs_spg(g, 0, 5),
                 lambda: baselines.bibfs_spg_batch(g, [0], [5]),
                 lambda: serve.main(["--n", "40", "--queries", "2"]),
                 lambda: serve.main(["--n", "40", "--queries", "2",
                                     "--replicas", "2", "--metrics-port", "0"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
