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

A cell's cards: ``rec.devices`` lists one device per chip the cell asks
for, ``cuda:0`` to ``cuda:<chips - 1>`` in a benchmark run and
``[device] * chips`` on the CPU; a system that spans several builds its
mesh from them.  ``rec.synchronize()``, which systems and drivers call
where they time, and the profiled slice wait for every one of its CUDA
cards (``rec.cards``; none on the CPU).  The harness resets the memory
peak of each before ``setup``, reports the highest card's as ``peak_gib``
and ``memory_peak_bytes``, and empties each card's cache after
``release()``.  A traced run's ``busy_s`` is the mean of the cards' busy
times.  ``with_cell`` adds a cell that ``BENCHMARK.json`` does not hold
(``run.py --shards``, the tests).
"""
from __future__ import annotations

import copy
import gc
import importlib.util
import json
import sys
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from pathlib import Path

import torch

from . import devtrace
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


def with_cell(bench: dict, cell: dict, like: str) -> dict:
    """A copy of ``bench`` that holds ``cell`` too, listed by every metric
    that lists the cell ``like``."""
    bench = copy.deepcopy(bench)
    bench["workloads"].append(cell)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", ()):
            m["workloads"].append(cell["name"])
    return bench


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

    def __init__(self, trace: bool, t_start: float, devices):
        self.trace = trace
        self.t_start = t_start
        self.devices = [torch.device(d) for d in devices]
        self.cards = [d for d in self.devices if d.type == "cuda"]
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

    def synchronize(self) -> None:
        """Wait for every card of the cell."""
        devtrace.synchronize(self.cards)

    def setup_done(self) -> None:
        self.setup_s = time.perf_counter() - self.t_start

    @contextmanager
    def profiled(self):
        """Profile the body (a traced run's slice); ``finish`` reads it."""
        self.in_slice = True
        try:
            with ProfiledSlice(self.cards) as self._slice:
                yield
        finally:
            self.in_slice = False

    def finish(self) -> None:
        """Take the wrappers out and reduce the profiled slice into ``raw``."""
        self.restore()
        if self._slice is not None:
            self.raw.update(self._slice.reduce())
            self._slice = None


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, *, config: dict | None = None,
             log=None) -> dict:
    """Run one cell once and return the result object.  ``config``
    replaces the cell's configuration file (the tests' small sizes);
    ``device`` is ``"cuda"`` in a benchmark run, and the cell's ``chips``
    set its cards (``rec.devices``)."""
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    cell = cell_of(bench, workload)
    cfg = config or load_json("configs", cell["config"])
    traffic = load_json("traffic", cell["traffic"])
    system_mod = load_module("systems", cfg["system"])
    driver_mod = load_module("drivers", traffic["driver"])
    on_cuda = torch.device(device).type == "cuda"
    chips = int(cell["chips"])
    rec = Recorder(trace, t_start, [torch.device("cuda", i) for i in range(chips)]
                   if on_cuda else [device] * chips)
    if on_cuda:
        torch.cuda.init()      # the peaks of a card named by index need it
    for d in rec.cards:
        torch.cuda.reset_peak_memory_stats(d)
    by_card = lambda peaks: ", ".join(f"{d} {p} B" for d, p in zip(rec.cards, peaks))
    try:
        system = system_mod.setup(cfg, seed, device, rec)
        win = driver_mod.run(system, traffic, seed, seconds, rec)
    except torch.cuda.OutOfMemoryError:
        log("out of memory; peak by card: "
            + by_card([torch.cuda.max_memory_allocated(d) for d in rec.cards]))
        raise
    finally:
        rec.finish()
    rec.synchronize()
    peaks = [torch.cuda.max_memory_allocated(d) for d in rec.cards]
    peak = max(peaks, default=0)
    edges, n = system.edges, system.n_vertices
    e2e = dict(win.metrics, setup_s=rec.setup_s, peak_gib=peak / (1 << 30))
    system.release()
    del system
    gc.collect()
    for d in rec.cards:
        with torch.cuda.device(d):
            torch.cuda.empty_cache()

    t0 = time.perf_counter()
    counts = judging.judge(edges, n, win.answers, device)
    ok, checks = judging.verdict(counts)
    for line in win.notes:
        log(line)
    log("set-up: " + ", ".join(f"{k} {rec.raw[k]:.3f}" for k in
                                ("graph_s", "from_edges_s", "labelling_s", "build_s")
                                if k in rec.raw)
        + f"; setup_s {rec.setup_s:.3f}")
    if rec.cards:
        log("peak by card: " + by_card(peaks))      # before the reference ran
    if "busy_s_by_card" in rec.raw:
        log("busy by card: " + ", ".join(
            f"{c} {100 * b / rec.raw['window_s']:.2f}%"
            for c, b in rec.raw["busy_s_by_card"].items()))
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
           "count": chips if on_cuda else 1,
           "memory_peak_bytes": int(peak)}
    out = {"correct": ok, "attempted": win.attempted, "failed": counts["missing"],
           "metrics": metrics, "device": dev}
    if trace and "busy_s" in rec.raw:
        dev["busy_s"] = rec.raw["busy_s"]
        dev["window_s"] = rec.raw["window_s"]
        out["breakdown"] = rec.raw["breakdown"]
    out["checks"] = checks
    return out
