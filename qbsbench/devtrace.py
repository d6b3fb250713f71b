"""A profiled slice of a run and its reduction: the device's busy time (the
union of the intervals in which an operation ran on the device), the
device operations that took most time, and the longest idle gaps named by
what the host was doing (the harness span and the innermost host
operation that covered the gap's middle).

The harness's spans are ``torch.profiler.record_function`` ranges named
``qbsbench.*``; they wrap calls into the program's layers in a traced run.
"""
from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch

SPAN = "qbsbench."
SLICE = "qbsbench.slice"
TOP = 10


def short_name(name: str) -> str:
    """A kernel's or operation's name without its return type, template
    arguments, parameter list and namespaces."""
    s = name[5:] if name.startswith("void ") else name
    s = s.replace("(anonymous namespace)::", "")
    out, depth = [], 0
    for ch in s:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(depth - 1, 0)
        elif depth == 0:
            if ch == "(" and out:
                break
            out.append(ch)
    base = "".join(out).strip()
    base = base.rsplit("::", 1)[-1] if "::" in base else base
    return (base or name)[:64]


def _is_span(e) -> bool:
    return e.name.startswith(SPAN) or bool(getattr(e, "is_user_annotation", False))


def _innermost(starts, ends, names, t: float, default: str, scan: int = 64) -> str:
    """The latest-started interval that covers ``t``, looked for among the
    ``scan`` intervals that started last before it."""
    i = int(np.searchsorted(starts, t, side="right")) - 1
    for j in range(i, max(i - scan, -1), -1):
        if ends[j] >= t:
            return names[j]
    return default


def _intervals(evts):
    evts = sorted(evts, key=lambda e: e.time_range.start)
    return (np.array([e.time_range.start for e in evts], float),
            np.array([e.time_range.end for e in evts], float),
            [e.name for e in evts])


def reduce_events(events, wall_s: float) -> dict:
    """Reduce a profiler's events (``prof.events()``) of one slice."""
    cuda = torch.autograd.DeviceType.CUDA
    dev = [e for e in events if e.device_type == cuda and not _is_span(e)]
    host = [e for e in events if e.device_type != cuda]
    win = [e for e in host if e.name == SLICE]
    if win:
        w0, w1 = win[0].time_range.start, win[0].time_range.end
    elif dev:
        w0 = min(e.time_range.start for e in dev)
        w1 = max(e.time_range.end for e in dev)
    else:
        w0 = w1 = 0.0
    by_name: dict[str, float] = defaultdict(float)
    iv: list[tuple[float, float]] = []
    for e in dev:
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        by_name[short_name(e.name)] += (e.time_range.end - e.time_range.start) * 1e-6
        if b > a:
            iv.append((a, b))
    segs: list[list[float]] = []          # the union of the intervals
    for a, b in sorted(iv):
        if segs and a <= segs[-1][1]:
            segs[-1][1] = max(segs[-1][1], b)
        else:
            segs.append([a, b])
    busy = sum(b - a for a, b in segs)
    gaps, prev = [], w0
    for a, b in segs:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))

    ops = _intervals([e for e in host if not _is_span(e)])
    spans = _intervals([e for e in host if _is_span(e) and e.name != SLICE])
    gap_by: dict[str, float] = defaultdict(float)
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:5000]:
        mid = 0.5 * (a + b)
        label = (_innermost(*spans, mid, "-") + " / "
                 + short_name(_innermost(*ops, mid, "python")))
        gap_by[label] += (b - a) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {
        "busy_s": busy * 1e-6,
        "window_s": wall_s,
        "kernel_device_s": dict(by_name),
        "breakdown": {"device_ops": top(by_name), "idle_gaps": top(gap_by)},
    }


class ProfiledSlice:
    """``with ProfiledSlice() as s: work()`` profiles the work (host and
    device) and synchronises at its end; ``s.reduce()`` reads the trace
    afterwards (``reduce_events``), outside the measured work."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._span = torch.profiler.record_function(SLICE)
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = time.perf_counter() - self._t0
        self._span.__exit__(*exc)
        self._prof.__exit__(*exc)
        self._wall = wall
        return False

    def reduce(self) -> dict:
        return reduce_events(self._prof.events(), self._wall)
