"""Spans and counters inside the port, on only while a torch profiler records.

    with torch.profiler.profile(activities=[...]):
        index.query_batch(us, vs)
    table = trace.report()      # per span: calls, host ms, device ms

``span(name, on)`` marks a stage of the program.  With no profiler
recording it returns one shared no-op context: no object, no clock read, no
CUDA event.  While a profiler records, a span opens
``torch.profiler.record_function("qbs." + name)``, so the stage appears in
the profiler's trace beside the device's kernels, reads the host's
``perf_counter_ns`` at entry and exit and, when ``on`` (a tensor or a
device) is on a CUDA device, records a timing ``torch.cuda.Event`` at entry
and exit on that device's current stream.  A span opened with
``chunk=True`` (``QbSIndex.serve_step``) starts a new chunk id; every span
opened inside it carries that id.

``count(name, n)`` adds ``n`` to a counter under the same gate and charges
it to the innermost open span.  Callers pass values the host already holds
(loop trip counts, sizes after a ``nonzero``): a counter never reads the
device.

Nothing here synchronises except ``report()``, which waits once per device
that recorded events and then reads them.  Nothing is written to disk.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import nullcontext

import torch

PREFIX = "qbs."

_OFF = nullcontext()
_local = threading.local()
_lock = threading.Lock()
_records: list[_Record] = []
_counters: dict[str, int] = defaultdict(int)
_next_chunk = 0


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Record:
    __slots__ = ("id", "name", "parent", "chunk", "device", "t0", "t1",
                 "ev0", "ev1", "counts")

    def __init__(self, id, name, parent, chunk, device):
        self.id = id
        self.name = name
        self.parent = parent
        self.chunk = chunk
        self.device = device
        self.t0 = self.t1 = None
        self.ev0 = self.ev1 = None
        self.counts: dict[str, int] = {}


class _Span:
    __slots__ = ("_name", "_on", "_chunk", "_rec", "_fn")

    def __init__(self, name: str, on, chunk: bool):
        self._name, self._on, self._chunk = name, on, chunk

    def __enter__(self):
        global _next_chunk
        stack = _stack()
        parent = stack[-1] if stack else None
        dev = getattr(self._on, "device", self._on)
        if dev is not None and torch.device(dev).type != "cuda":
            dev = None
        with _lock:
            if self._chunk:
                _next_chunk += 1
                chunk_id = _next_chunk
            else:
                chunk_id = parent.chunk if parent is not None else None
            rec = self._rec = _Record(
                len(_records), self._name,
                parent.id if parent is not None else None, chunk_id, dev)
            _records.append(rec)
        stack.append(rec)
        self._fn = torch.profiler.record_function(PREFIX + rec.name)
        self._fn.__enter__()
        if dev is not None:
            rec.ev0 = torch.cuda.Event(enable_timing=True)
            rec.ev0.record(torch.cuda.current_stream(dev))
        rec.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self._rec
        rec.t1 = time.perf_counter_ns()
        if rec.device is not None:
            rec.ev1 = torch.cuda.Event(enable_timing=True)
            rec.ev1.record(torch.cuda.current_stream(rec.device))
        self._fn.__exit__(*exc)
        _stack().pop()
        return False


def span(name: str, on=None, *, chunk: bool = False):
    """A context over one stage: a no-op unless a profiler records (module
    docstring).  ``on``: a tensor or device whose CUDA stream the span
    times; ``chunk``: start a new chunk id."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, on, chunk)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` (a host value) to counter ``name`` while a profiler records,
    charged to the innermost open span."""
    if not torch.autograd._profiler_enabled():
        return
    stack = _stack()
    with _lock:
        _counters[name] += n
        if stack:
            counts = stack[-1].counts
            counts[name] = counts.get(name, 0) + n


def reset() -> None:
    """Forget every span record and counter."""
    global _next_chunk
    with _lock:
        _records.clear()
        _counters.clear()
        _next_chunk = 0


def report() -> dict:
    """What was recorded since the last ``reset``: ``spans`` maps a span's
    name to ``calls``, ``host_ms``, ``device_ms`` and ``self_device_ms``
    (the span's device time less its children's; both ``None`` for spans
    that recorded no CUDA event), ``counters`` maps a counter to its total,
    and ``records`` lists every closed span (``id``, ``name``, ``parent``
    id, ``chunk`` id, ``host_ms``, ``device_ms``, ``counts``)."""
    with _lock:
        recs = [r for r in _records if r.t1 is not None]
        counters = dict(_counters)
    for dev in {r.device for r in recs if r.ev1 is not None}:
        torch.cuda.synchronize(dev)
    rows = []
    child_ms: dict[int, float] = defaultdict(float)
    for r in recs:
        dev_ms = r.ev0.elapsed_time(r.ev1) if r.ev1 is not None else None
        if dev_ms is not None and r.parent is not None:
            child_ms[r.parent] += dev_ms
        rows.append({"id": r.id, "name": r.name, "parent": r.parent,
                     "chunk": r.chunk, "host_ms": (r.t1 - r.t0) * 1e-6,
                     "device_ms": dev_ms, "counts": dict(r.counts)})
    spans: dict[str, dict] = {}
    for row in rows:
        s = spans.setdefault(row["name"], {"calls": 0, "host_ms": 0.0,
                                           "device_ms": None,
                                           "self_device_ms": None})
        s["calls"] += 1
        s["host_ms"] += row["host_ms"]
        if row["device_ms"] is not None:
            s["device_ms"] = (s["device_ms"] or 0.0) + row["device_ms"]
            s["self_device_ms"] = ((s["self_device_ms"] or 0.0) + row["device_ms"]
                                   - child_ms[row["id"]])
    return {"spans": spans, "counters": counters, "records": rows}
