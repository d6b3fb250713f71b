"""A profiled slice of a run and its reduction: the cards' busy time (per
card, the union of the intervals in which an operation ran on it,
averaged over the cell's cards), the device operations that took most
time (summed over the cards), and the longest idle gaps, where no card of
the cell ran, named by what the host was doing (the harness span and the
innermost host operation that covered the gap's middle).

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


def synchronize(cards) -> None:
    """Wait for each of ``cards`` (CUDA devices; none on the CPU)."""
    for d in cards:
        torch.cuda.synchronize(d)


def _union(iv) -> list[list[float]]:
    segs: list[list[float]] = []
    for a, b in sorted(iv):
        if segs and a <= segs[-1][1]:
            segs[-1][1] = max(segs[-1][1], b)
        else:
            segs.append([a, b])
    return segs


def reduce_events(events, wall_s: float, cards) -> dict:
    """Reduce a profiler's events (``prof.events()``) of one slice.
    ``cards`` are the device indices of the cell's cards: ``busy_s`` is the
    mean over them of each card's busy time (``busy_s_by_card``).  An event
    counts on the card of its ``device_index``; with one card, every event
    counts on it."""
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
    by_card: dict[int, list[tuple[float, float]]] = defaultdict(list)
    cards = list(cards)
    only = cards[0] if len(cards) == 1 else None
    for e in dev:
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        by_name[short_name(e.name)] += (e.time_range.end - e.time_range.start) * 1e-6
        if b > a:
            card = getattr(e, "device_index", 0) if only is None else only
            by_card[card].append((a, b))
    busy = {c: sum(b - a for a, b in _union(by_card.get(c, ()))) for c in cards}
    segs = _union([x for iv in by_card.values() for x in iv])   # some card ran
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
        "busy_s": sum(busy.values()) / len(cards) * 1e-6,
        "busy_s_by_card": {c: t * 1e-6 for c, t in busy.items()},
        "window_s": wall_s,
        "kernel_device_s": dict(by_name),
        "breakdown": {"device_ops": top(by_name), "idle_gaps": top(gap_by)},
    }


class ProfiledSlice:
    """``with ProfiledSlice(cards) as s: work()`` profiles the work (host
    and device) and waits at its end for the cell's CUDA ``cards``;
    ``s.reduce()`` reads the trace afterwards (``reduce_events``, over
    those cards), outside the measured work."""

    def __init__(self, cards):
        self.cards = list(cards)

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
        synchronize(self.cards)
        wall = time.perf_counter() - self._t0
        self._span.__exit__(*exc)
        self._prof.__exit__(*exc)
        self._wall = wall
        return False

    def reduce(self) -> dict:
        # on the CPU, one notional card that no CUDA event names
        return reduce_events(self._prof.events(), self._wall,
                             [d.index for d in self.cards] or [0])
