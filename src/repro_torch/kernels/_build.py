"""Build and bind the CUDA kernels: ``nvcc`` into one shared library per
source, a plain C interface, ``ctypes`` for the binding.

Each ``csrc/<name>.cu`` compiles on first use for ``sm_90a`` into
``build/repro_torch_kernels/<name>-<hash>.so`` under the repository root
(the hash is of the source and the flags, so an edited source rebuilds).
``build_all()`` starts one ``nvcc`` per source at once and waits for all.
Nothing here runs when the package is imported, and nothing falls back:
a build failure raises with the compiler's output.

``load`` holds a lock while it builds and binds, so a first launch from a
streaming scheduler's timer thread and one from the main thread cannot
build or bind the same library twice.

``LAUNCHES`` counts kernel launches per kernel; each wrapper adds one where
it launches its kernel and nowhere else (``kernels.ops.LAUNCHES``).  The
fused relay's one count per call stands for its two launches (pack, then
pull); the side attach and the sharded attach count each of their kernels'
launches (certificate, each closure step, edge pass; the sharded attach's
once per shard).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("minplus", "sketch_batch", "bitmap_expand_packed", "bitmap_expand",
           "hybrid_relay", "side_attach", "sharded_attach")

LAUNCHES = {name: 0 for name in SOURCES}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()
BUILD_LOG: dict[str, str] = {}   # per-source nvcc output (ptxas register/smem report)


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built on first use on a machine with the card")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str):
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    BUILD_LOG[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)   # atomic: a concurrent builder sees old or new


def build_all(names=SOURCES) -> None:
    """Compile every listed source that has no current library, one
    ``nvcc`` per source, all started together."""
    started = {n: _start(n) for n in names}
    for n, s in started.items():
        _finish(n, s)


def load(name: str) -> ctypes.CDLL:
    """The bound library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOAD_LOCK:
        lib = _LIBS.get(name)          # another thread may have bound it
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(_target(name)))
            lib.qbs_error_string.restype = ctypes.c_char_p
            lib.qbs_error_string.argtypes = [ctypes.c_int]
            _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` code returned by a launch."""
    if rc != 0:
        msg = lib.qbs_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")
