"""Injectable monotonic clocks for the streaming scheduler (DESIGN.md §8).
A copy of ``repro.serving.clock`` (host-only; the port imports nothing of
the reference package).

Every deadline behavior in ``serving.stream`` — wall-clock admission
bounds, the idle-backlog flush timer, wait accounting — reads time and
arms timers through this interface instead of calling ``time`` directly,
so the whole scheduling policy surface is testable (and benchmarkable)
in *simulated* time with zero wall-clock sleeps:

* ``SystemClock`` — production: ``time.monotonic`` plus daemon
  ``threading.Timer`` callbacks.  This is what lets a query sitting alone
  in the backlog get admitted with no further caller traffic.
* ``ManualClock`` — tests/benchmarks: time only moves when the caller
  calls ``advance``/``advance_to``, which fires due callbacks *in
  deadline order, at their scheduled instants* (``now()`` reads the
  firing callback's own due time while it runs).  Deterministic by
  construction — scheduler decisions depend only on the trace, never on
  host speed.

The contract is two methods: ``now() -> float`` (monotonic seconds) and
``call_at(t, fn) -> handle`` where ``handle.cancel()`` best-effort
revokes a not-yet-fired callback.  Callbacks may re-arm new timers.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Callable


class SystemClock:
    """Real time: ``time.monotonic`` + daemon ``threading.Timer``s.

    Callbacks fire on a timer thread — ``StreamingService`` serializes
    them against ``submit``/``drain`` with its own lock."""

    def now(self) -> float:
        return time.monotonic()

    def call_at(self, t: float, fn: Callable[[], None]):
        timer = threading.Timer(max(0.0, t - self.now()), fn)
        timer.daemon = True
        timer.start()
        return timer                      # threading.Timer has .cancel()


class _ManualTimer:
    __slots__ = ("fn", "cancelled")

    def __init__(self, fn: Callable[[], None]):
        self.fn = fn
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True


class ManualClock:
    """Deterministic test/bench clock: time moves only via ``advance``.

    ``advance`` fires every due callback at its exact scheduled time (in
    order, ``now()`` returning that time during the callback), so a
    deadline of ``t`` produces an admission stamped *at* ``t`` no matter
    how far past it the caller jumps — waits never exceed the bound by
    simulation artifacts."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self._heap: list[tuple[float, int, _ManualTimer]] = []
        self._seq = itertools.count()

    def now(self) -> float:
        return self._now

    def call_at(self, t: float, fn: Callable[[], None]) -> _ManualTimer:
        h = _ManualTimer(fn)
        # never schedule into the past: a due-now callback fires on the
        # next advance (even advance(0)), like a 0-delay system timer
        heapq.heappush(self._heap, (max(float(t), self._now), next(self._seq), h))
        return h

    def advance(self, dt: float) -> None:
        self.advance_to(self._now + float(dt))

    def advance_to(self, t: float) -> None:
        t = float(t)
        while self._heap and self._heap[0][0] <= t:
            due, _, h = heapq.heappop(self._heap)
            if h.cancelled:
                continue
            self._now = max(self._now, due)
            h.fn()                        # may re-arm timers <= t: loop sees them
        self._now = max(self._now, t)
