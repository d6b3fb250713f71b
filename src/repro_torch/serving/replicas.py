"""Replica serving tier: N shared-nothing streaming replicas behind a
consistent-hash router (DESIGN.md §12).  A copy of
``repro.serving.replicas`` (host-only; the port imports nothing of the
reference package).  All replicas share the one device of the index.

One ``StreamingService`` process is not "millions of users".  The router
owns N replicas — each a full ``StreamingService`` over its *own*
``ServingService`` (own scheduler, own lock, own result cache, own
injectable clock) — and routes every query by consistent hashing on the
canonical ``(min, max)`` pair key.  Because the cache key *is* the
routing key, each cached pair lives on exactly one replica: the
hub-skewed repeat traffic that makes PLL-style label serving cacheable
partitions across the tier instead of duplicating into every replica's
cache (summed hot-key bytes stay at the single-service level however
many replicas run — pinned by ``tests/test_replica_router.py``).

* **Consistent hashing.**  Each replica owns ``vnodes`` points on a
  64-bit ring, positioned by a splitmix64-style integer mix (never
  Python's randomized ``hash``) so placement is deterministic across
  processes and runs.  A key routes to the first *live* replica at or
  after its ring point; draining a replica therefore re-routes only that
  replica's key range — the consistent-hashing property that makes
  rolling restarts cheap.
* **Drain/handoff.**  ``drain_replica(i)`` marks ``i`` not live (its
  range re-routes), atomically exports its pending pairs
  (``StreamingService.handoff_pending``) into their new owners
  (``adopt`` — futures re-target the adopting replica, keep their submit
  times and deadlines), then drains ``i``'s in-flight window so every
  already-dispatched future resolves in place.  No future is dropped or
  double-resolved, and the accounting identity holds per replica
  (``handed_off`` balances the exported creators).  Cache residency
  moves with ownership in both directions: drain ships ``i``'s packed
  cache entries to the covering peers, restore ships the range's
  entries back — so neither the drain nor the rejoin serves its hot set
  cold (the restored-replica p99 spike this tier used to pay).
* **Epoch fan-out** (DESIGN.md §13).  ``apply_update`` computes the next
  epoch's index once and installs it on every replica under the router
  lock, so the tier advances atomically with respect to routing — no
  two replicas ever serve the same pair from different epochs.
* **Bit-identity.**  Routing only partitions *which* replica computes a
  pair; every replica serves from the same index, so
  ``ReplicaRouter(n_replicas=N)`` is bit-identical to a single service
  on ``(dist, edge_ids)`` — pinned against the numpy oracle by the
  property fuzz harness for any interleaving of submits, clock advances,
  drains, and mid-trace replica drains/restores.

Per-replica clocks: pass ``clocks=[...]`` (one per replica — tests and
``benchmarks/trace_replay.py`` drive lockstep ``ManualClock``s) or leave
``None`` for per-replica ``SystemClock``s.  Clocks must share a time
base: handed-off submit times are compared against the adopter's clock.
"""
from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Sequence

import numpy as np

from . import debug
from .clock import SystemClock
from .stream import StreamingService

_MASK64 = (1 << 64) - 1


def mix64(x: int) -> int:
    """splitmix64 finalizer: deterministic 64-bit avalanche mix."""
    x &= _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def key_point(key: tuple[int, int]) -> int:
    """Ring position of a canonical pair key (vertex ids fit 31 bits)."""
    return mix64((key[0] << 32) | (key[1] & 0xFFFFFFFF))


class ReplicaRouter:
    """Consistent-hash front-end over N shared-nothing streaming replicas.

    Construction kwargs mirror ``StreamingService`` — ``policy=``,
    ``qos=``, plus the inner ``ServingService`` kwargs (``cache_size=``,
    ``cache_policy=``, ...) — and apply to *every* replica, so the tier
    is homogeneous (a requirement of handoff: adopted pairs must find
    their QoS class on the new owner).

    Lock discipline matches ``StreamingService``: ``_live`` and
    ``stats`` are mutated only under ``with self._lock`` (QBS005 + the
    runtime sanitizer); each replica's scheduler state stays behind its
    own lock — the router never reaches into one.
    """

    _QBS_GUARDED_FIELDS = ("_live", "stats")

    def __init__(self, index, *, n_replicas: int = 2, vnodes: int = 64,
                 clocks: Sequence | None = None, sanitize: bool | None = None,
                 **stream_kw):
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        if clocks is not None and len(clocks) != n_replicas:
            raise ValueError(
                f"clocks has {len(clocks)} entries for {n_replicas} replicas")
        object.__setattr__(self, "_qbs", None)
        san = debug.sanitizer(sanitize)
        box = san if san is not None else debug.PLAIN
        self.index = index
        self.replicas: tuple[StreamingService, ...] = tuple(
            StreamingService(
                index,
                clock=(clocks[i] if clocks is not None else SystemClock()),
                sanitize=sanitize, **stream_kw)
            for i in range(n_replicas))
        # the ring: vnodes points per replica, sorted once — liveness is
        # checked at lookup (a dead replica's points are skipped), so
        # drain/restore never rebuilds the ring
        points = []
        for i in range(n_replicas):
            for j in range(vnodes):
                points.append((mix64(0x9E3779B97F4A7C15 * (i + 1) + j), i))
        points.sort()
        self._ring_points = [p for p, _ in points]
        self._ring_owner = [i for _, i in points]
        self._live = box.list([True] * n_replicas,
                              what="ReplicaRouter._live")
        self.stats = box.dict({
            "routed": 0,          # queries routed to a replica
            "drains": 0,          # drain_replica calls
            "restores": 0,        # restore_replica calls
            "handoffs": 0,        # pairs re-homed by drains
            "cache_shipped": 0,   # packed cache entries moved with key
                                  # ownership (drain + restore warmups)
            "updates": 0,         # epoch advances fanned out (§13)
        }, what="ReplicaRouter.stats")
        self._lock = san.lock if san is not None else threading.RLock()
        self._qbs = san

    def __setattr__(self, name, value):
        qbs = self.__dict__.get("_qbs")
        if qbs is not None and name in self._QBS_GUARDED_FIELDS:
            qbs.assert_owned(f"ReplicaRouter.{name}")
        object.__setattr__(self, name, value)

    # -- routing -------------------------------------------------------------

    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    def live_replicas(self) -> list[int]:
        with self._lock:
            return [i for i, up in enumerate(self._live) if up]

    def _owner_locked(self, key: tuple[int, int]) -> int:  # qbslint: locked
        return self._owner_of(key, self._live)

    def _owner_of(self, key: tuple[int, int], live) -> int:
        """Ring lookup against an explicit liveness vector.  ``_live``
        callers hold the lock; snapshot callers (``_owner_fn``) pass an
        immutable copy so the lookup itself is lock-free."""
        pts, owners = self._ring_points, self._ring_owner
        n = len(pts)
        start = bisect_left(pts, key_point(key)) % n
        for step in range(n):
            i = owners[(start + step) % n]
            if live[i]:
                return i
        raise RuntimeError("no live replica")

    def _owner_fn(self):
        """A pure owner-lookup closure over a liveness snapshot — safe to
        call while holding a *replica's* lock (the cache warm-handoff
        export predicates), where taking the router lock would invert
        the router->replica lock order."""
        with self._lock:
            live = tuple(self._live)
        return lambda key: self._owner_of(key, live)

    def owner_of(self, u: int, v: int) -> int:
        """Replica index currently owning the canonical pair (u, v)."""
        with self._lock:
            return self._owner_locked((min(int(u), int(v)),
                                       max(int(u), int(v))))

    # -- submission ----------------------------------------------------------

    def submit(self, u: int, v: int, qos: str | None = None):
        return self.submit_batch([u], [v], qos=qos)[0]

    def submit_batch(self, us, vs, qos: str | None = None) -> list:
        """Route a batch to its owning replicas; returns futures in the
        caller's order.  Pairs sharing an owner go down in one
        ``submit_batch`` so per-replica coalescing/dedup still sees the
        whole sub-batch."""
        us = np.asarray(us, np.int32).reshape(-1)
        vs = np.asarray(vs, np.int32).reshape(-1)
        with self._lock:
            by_owner: dict[int, list[int]] = {}
            for k, (u, v) in enumerate(zip(us.tolist(), vs.tolist())):
                i = self._owner_locked((min(u, v), max(u, v)))
                by_owner.setdefault(i, []).append(k)
            self.stats["routed"] += int(us.size)
        futs: list = [None] * us.size
        for i, rows in by_owner.items():
            got = self.replicas[i].submit_batch(us[rows], vs[rows], qos=qos)
            for k, fut in zip(rows, got):
                futs[k] = fut
        return futs

    def drain(self) -> None:
        """Drain every replica (live and draining — in-flight work on a
        drained replica still resolves here)."""
        for rep in self.replicas:
            rep.drain()

    def poll(self) -> None:
        for rep in self.replicas:
            rep.poll()

    def query_batch(self, us, vs) -> list:
        """One-shot wrapper: submit everything, drain the tier, collect
        — bit-identical to a single service on ``(dist, edge_ids)``."""
        futs = self.submit_batch(us, vs)
        self.drain()
        return [f.result() for f in futs]

    # -- rolling restarts ----------------------------------------------------

    def drain_replica(self, i: int) -> int:
        """Take replica ``i`` out of rotation for a rolling restart:
        re-route its key range, re-home its pending pairs into the new
        owners, resolve its in-flight window in place, and *move* its
        packed result-cache entries to the keys' new owners (the warm
        half of the handoff: re-routed repeat traffic keeps hitting
        instead of recomputing its hot set cold).  Returns the number of
        pairs handed off; ``restore_replica`` puts the replica back."""
        with self._lock:
            if not self._live[i]:
                raise ValueError(f"replica {i} is already draining")
            if sum(self._live) == 1:
                raise ValueError("cannot drain the last live replica")
            self._live[i] = False
            self.stats["drains"] += 1
        handoff = self.replicas[i].handoff_pending()
        for key, futures, qos, t_enq, deadline in handoff:
            with self._lock:
                j = self._owner_locked(key)
                self.stats["handoffs"] += 1
            self.replicas[j].adopt(key, futures, qos=qos, t_enq=t_enq,
                                   deadline=deadline)
        self.replicas[i].drain()       # in-flight pairs resolve in place
        self._ship_cache_from(i)
        return len(handoff)

    def restore_replica(self, i: int) -> None:
        """Return a drained replica to rotation: its key range routes
        back on the next lookup (keys handed off while draining finish
        where they were adopted), and the range's packed cache entries
        ship back from the covering peers — without this the restored
        replica rejoins *cold* and every repeat pair in its range pays a
        full recompute (the post-restore p99 spike pinned by
        ``benchmarks/trace_replay.py``)."""
        with self._lock:
            if self._live[i]:
                raise ValueError(f"replica {i} is already live")
            self._live[i] = True
            self.stats["restores"] += 1
        # peers covered i's range while it was out; with i live again,
        # any entry now owned by i moves home (cache keys are epoched
        # (u, v, epoch) — routing reads the pair, key[:2])
        owner = self._owner_fn()
        moved = 0
        for j, rep in enumerate(self.replicas):
            if j == i:
                continue
            entries = rep.export_cache(
                pred=lambda key: owner(key[:2]) == i, remove=True)
            if entries:
                self.replicas[i].import_cache(entries)
                moved += len(entries)
        with self._lock:
            self.stats["cache_shipped"] += moved

    def _ship_cache_from(self, i: int) -> None:
        """Move every packed cache entry off replica ``i`` to its key's
        current owner (``i`` is live=False here, so its range re-routes).
        Entries land with their packed payloads intact, so the adopting
        replicas serve the drained hot set from cache immediately."""
        owner = self._owner_fn()
        moved = self.replicas[i].export_cache(remove=True)
        by_owner: dict[int, list] = {}
        for key, entry in moved:
            by_owner.setdefault(owner(key[:2]), []).append((key, entry))
        for j, entries in by_owner.items():
            self.replicas[j].import_cache(entries)
        with self._lock:
            self.stats["cache_shipped"] += len(moved)

    # -- dynamic updates (DESIGN.md §13) -------------------------------------

    def apply_update(self, inserts=None, deletes=None, *,
                     churn_threshold: float = 0.5):
        """Advance the whole tier one epoch: compute the next index
        *once* (incremental label maintenance on the routed index) and
        install it on every replica — live and draining alike, so a
        restored replica is never behind the tier's epoch.  Serialized
        under the router lock: concurrent updates install in epoch order
        on every replica (router -> replica is the tier's one lock
        order).  Returns the new index."""
        with self._lock:
            new = self.index.apply_update(inserts=inserts, deletes=deletes,
                                          churn_threshold=churn_threshold)
            self.index = new
            for rep in self.replicas:
                rep.install_index(new)
            self.stats["updates"] += 1
        return new

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        for rep in self.replicas:
            rep.close()

    def __enter__(self) -> "ReplicaRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
