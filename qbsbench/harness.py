"""The harness: finds a cell's files by name, runs it, judges it and builds
the result line.

``BENCHMARK.json`` names each cell's configuration and traffic mix.  A
configuration is ``configs/<name>.json`` and names its deployment code,
``systems/<system>.py``; a traffic mix is ``traffic/<name>.json`` and names
its driver, ``drivers/<driver>.py``; a per-layer metric is
``metrics/<name>.py``, a reader with ``read(raw) -> float | None``.  Adding
a cell, a metric or a kind of system adds files and edits none.

A system module has ``setup(config, seed, device, rec)``, which returns an
object with ``edges``, ``n_vertices`` and ``release()``.  A
driver module has ``run(system, traffic, seed, seconds, rec)``, which warms
up, calls ``rec.setup_done()`` just before the first timed request,
measures and returns a ``Window``.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from pathlib import Path

import torch

from . import judge as judging
from .devtrace import SPAN, ProfiledSlice

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_benchmark(path: Path | None = None) -> dict:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(kind: str, name: str) -> dict:
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``qbsbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"qbsbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_of(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN and sys.modules.get(m) is not None})


@dataclass
class Window:
    """What a driver's window gave: the requests it sent, their answers
    ``(u, v, dist | None, edge_ids | None)``, the end-to-end metrics it
    measured and lines for standard error."""

    attempted: int
    answers: list
    metrics: dict
    notes: list = field(default_factory=list)


class Recorder:
    """Per-run state of the harness: the set-up clock, the instrumentation
    of a traced run (wrappers it installs and takes out again, spans,
    counters) and the raw readings the per-layer readers read."""

    def __init__(self, trace: bool, t_start: float):
        self.trace = trace
        self.t_start = t_start
        self.setup_s: float | None = None
        self.raw: dict = {}
        self.in_slice = False
        self._slice: ProfiledSlice | None = None
        self._undo: list = []

    def patch(self, owner, name: str, make) -> None:
        """Replace ``owner.name`` by ``make(original)`` until ``restore``."""
        orig = getattr(owner, name)
        setattr(owner, name, make(orig))
        self._undo.append((owner, name, orig))

    def restore(self) -> None:
        while self._undo:
            owner, name, orig = self._undo.pop()
            setattr(owner, name, orig)

    def span(self, name: str):
        return torch.profiler.record_function(SPAN + name) if self.trace else nullcontext()

    def reset_counters(self) -> None:
        """Forget what warm-up counted; the window's counts start here."""
        for k in ("general_chunks", "general_chunk_s", "relay_bytes", "relay_calls"):
            self.raw.pop(k, None)

    def setup_done(self) -> None:
        self.setup_s = time.perf_counter() - self.t_start

    @contextmanager
    def profiled(self):
        """Profile the body (a traced run's slice); ``finish`` reads it."""
        self.in_slice = True
        try:
            with ProfiledSlice() as self._slice:
                yield
        finally:
            self.in_slice = False

    def finish(self) -> None:
        """Take the wrappers out and reduce the profiled slice into ``raw``."""
        self.restore()
        if self._slice is not None:
            self.raw.update(self._slice.reduce())
            self._slice = None


def synchronize() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, *, config: dict | None = None,
             log=None) -> dict:
    """Run one cell once and return the result object.  ``config``
    replaces the cell's configuration file (the tests' small sizes);
    ``device`` is ``"cuda"`` in a benchmark run."""
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    cell = cell_of(bench, workload)
    cfg = config or load_json("configs", cell["config"])
    traffic = load_json("traffic", cell["traffic"])
    system_mod = load_module("systems", cfg["system"])
    driver_mod = load_module("drivers", traffic["driver"])
    on_cuda = torch.device(device).type == "cuda"
    rec = Recorder(trace, t_start)
    try:
        system = system_mod.setup(cfg, seed, device, rec)
        win = driver_mod.run(system, traffic, seed, seconds, rec)
    finally:
        rec.finish()
    synchronize()
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    edges, n = system.edges, system.n_vertices
    e2e = dict(win.metrics, setup_s=rec.setup_s, peak_gib=peak / (1 << 30))
    system.release()
    del system
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    counts = judging.judge(edges, n, win.answers, device)
    ok, checks = judging.verdict(counts)
    for line in win.notes:
        log(line)
    log(f"reference: {counts['checked']} answers compared in "
        f"{time.perf_counter() - t0:.3f} s")

    if trace:
        metrics = {}
        for m in bench["per_layer"]:
            if applies(m, workload):
                value = load_module("metrics", m["name"]).read(rec.raw)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]
                 if applies(m, workload)}
        metrics = {k: {"value": e2e[k], "unit": u} for k, u in units.items()
                   if e2e.get(k) is not None}
    dev = {"platform": "gpu" if on_cuda else device,
           "kind": torch.cuda.get_device_name() if on_cuda else device,
           "count": int(cell["chips"]) if on_cuda else 1,
           "memory_peak_bytes": int(peak)}
    out = {"correct": ok, "attempted": win.attempted, "failed": counts["missing"],
           "metrics": metrics, "device": dev}
    if trace and "busy_s" in rec.raw:
        dev["busy_s"] = rec.raw["busy_s"]
        dev["window_s"] = rec.raw["window_s"]
        out["breakdown"] = rec.raw["breakdown"]
    out["checks"] = checks
    return out
