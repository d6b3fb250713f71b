"""Opt-in concurrency sanitizer for the streaming scheduler.  A copy of
``repro.serving.debug`` (host-only; the port imports nothing of the
reference package).

The static side of the lock discipline lives in ``tools/qbslint``
(QBS005: every mutation of a ``_QBS_GUARDED_FIELDS`` member happens
under ``with self._lock``).  Static analysis cannot see *dynamic* call
paths — a helper reached both with and without the lock, a callback
fired from a clock thread — so this module supplies the runtime half:

* ``OwnedRLock`` — an ``threading.RLock`` wrapper that records the
  owning thread, so ``owned()`` answers "does *this* thread hold it?".
* ``Sanitizer`` — factories for guarded ``dict``/``deque``/``list``
  subclasses whose mutators assert lock ownership before mutating, plus
  ``assert_owned`` for scalar attribute rebinds.
* ``ConcurrencyViolation`` — the ``AssertionError`` raised on a guarded
  mutation by a thread that does not hold the lock.

Enablement: ``StreamingService(..., sanitize=True)`` explicitly, or
``QBS_SANITIZE=1`` in the environment (``scripts/tier1.sh`` exports it,
so the whole tier-1 suite runs sanitized in CI).  Disabled, the service
uses plain builtins and an ordinary ``RLock`` — zero overhead.

Known gap: ``heapq``'s C implementation mutates lists through the
concrete ``PyList`` API, bypassing subclass methods, so pushes onto the
scheduler heap are only covered statically (QBS005 knows the ``heapq``
functions), not at runtime.
"""
from __future__ import annotations

import os
import threading
from collections import deque


class ConcurrencyViolation(AssertionError):
    """A guarded structure was mutated off-lock (see serving.debug)."""


def enabled() -> bool:
    """True when the ``QBS_SANITIZE`` env var asks for the sanitizer."""
    return os.environ.get("QBS_SANITIZE", "").strip().lower() in (
        "1", "true", "yes", "on")


class OwnedRLock:
    """Reentrant lock that tracks its owning thread.

    ``owned()`` is read without the lock held: the owner field is only
    written by the holder, so a racing reader either sees its own ident
    (it holds the lock) or someone else's/None (it does not) — exactly
    the answer the assertion needs.
    """

    __slots__ = ("_lock", "_owner", "_depth")

    def __init__(self):
        self._lock = threading.RLock()
        self._owner: int | None = None
        self._depth = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._owner = threading.get_ident()
            self._depth += 1
        return got

    def release(self) -> None:
        self._depth -= 1
        if self._depth == 0:
            self._owner = None
        self._lock.release()

    def __enter__(self) -> "OwnedRLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def owned(self) -> bool:
        return self._owner == threading.get_ident()


def _checked(base, name):
    orig = getattr(base, name)

    def method(self, *args, **kwargs):
        self._qbs_check()
        return orig(self, *args, **kwargs)

    method.__name__ = name
    method.__qualname__ = name
    return method


def _guarded_type(base, mutators):
    def __init__(self, qbs_check, *args, **kwargs):
        base.__init__(self, *args, **kwargs)
        self._qbs_check = qbs_check

    ns = {"__init__": __init__}
    for name in mutators:
        ns[name] = _checked(base, name)
    return type(f"Guarded{base.__name__.capitalize()}", (base,), ns)


_DICT_MUTATORS = ("__setitem__", "__delitem__", "pop", "popitem", "clear",
                  "update", "setdefault")
_DEQUE_MUTATORS = ("__setitem__", "__delitem__", "append", "appendleft",
                   "extend", "extendleft", "insert", "pop", "popleft",
                   "remove", "rotate", "clear")
_LIST_MUTATORS = ("__setitem__", "__delitem__", "append", "extend", "insert",
                  "pop", "remove", "sort", "reverse", "clear")

GuardedDict = _guarded_type(dict, _DICT_MUTATORS)
GuardedDeque = _guarded_type(deque, _DEQUE_MUTATORS)
GuardedList = _guarded_type(list, _LIST_MUTATORS)


class Sanitizer:
    """One lock + the guarded-container factories bound to it."""

    def __init__(self, lock: OwnedRLock | None = None):
        self.lock = lock or OwnedRLock()

    def assert_owned(self, what: str) -> None:
        if not self.lock.owned():
            raise ConcurrencyViolation(
                f"unlocked mutation of {what}: the mutating thread "
                f"(ident {threading.get_ident()}) does not hold the "
                f"service lock")

    def _check_for(self, what: str):
        # stored as an *instance* attribute on the guarded container, so
        # it is never descriptor-bound: a plain zero-arg closure
        def check():
            self.assert_owned(what)
        return check

    def check(self, what: str):
        """Public zero-arg ownership probe for guarded state that is not
        a container subclass (e.g. ``metrics.LatencyHistogram`` counts):
        the owner passes it as the object's ``check=`` hook."""
        return self._check_for(what)

    def dict(self, *args, what: str = "a guarded dict", **kwargs):
        return GuardedDict(self._check_for(what), *args, **kwargs)

    def deque(self, *args, what: str = "a guarded deque", **kwargs):
        return GuardedDeque(self._check_for(what), *args, **kwargs)

    def list(self, *args, what: str = "a guarded list", **kwargs):
        return GuardedList(self._check_for(what), *args, **kwargs)


class _Plain:
    """Disabled-path factories: plain builtins, an ordinary RLock."""

    def __init__(self):
        self.lock = None

    def assert_owned(self, what: str) -> None:
        pass

    def dict(self, *args, what: str = "", **kwargs):
        return dict(*args, **kwargs)

    def deque(self, *args, what: str = "", **kwargs):
        return deque(*args, **kwargs)

    def list(self, *args, what: str = "", **kwargs):
        return list(*args, **kwargs)


PLAIN = _Plain()


def sanitizer(explicit: bool | None = None) -> Sanitizer | None:
    """The service-facing switch: ``Sanitizer()`` when asked for
    (explicitly or via ``QBS_SANITIZE``), else ``None``."""
    on = enabled() if explicit is None else bool(explicit)
    return Sanitizer() if on else None
