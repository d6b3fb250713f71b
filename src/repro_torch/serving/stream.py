"""Deadline- and QoS-aware streaming scheduler over the serving service
(DESIGN.md §5 admission, §8 scheduling).  Counterpart of
``repro.serving.stream``: the scheduler is host code, copied as it is; the
one device-facing step, draining a dispatched chunk, goes through
``service.edge_ids_of`` (the SPG edge ids are extracted on the device, so
only they cross to the host, not the ``(chunk, E)`` mask).

The planner/executor pipeline (``serving.planner`` / ``serving.service``)
answers one complete batch at a time: the caller decides what constitutes
a batch.  Real traffic doesn't arrive that way — queries trickle and
burst, and different submitters deserve different treatment — so this
module owns the *when* and the *who*: a ``StreamingService`` accepts
queries as they arrive (``submit`` / ``submit_batch`` returning per-query
``QueryFuture``s, or the ``serve`` iterator), tags each with a QoS class
(``qos=``), and admits coalesced planner batches under a deficit-weighted,
deadline-bounded scheduler:

* **QoS classes** (``QoSClass``).  Each class carries a ``max_wait``
  wall-clock admission deadline and a scheduling ``weight``.  Untagged
  traffic rides the first (default) class, which has neither — the seed
  single-backlog behavior.
* **Deadline flush.**  A pending pair is admitted no later than
  ``submit_time + max_wait``: submissions and an idle-backlog timer
  (armed through the injectable ``clock`` — ``SystemClock`` in
  production, ``ManualClock`` in tests, see ``serving.clock``) both pump
  the scheduler, and a deadline firing also *syncs* the in-flight window
  so the overdue future resolves.  A query sitting alone in the backlog
  with no further traffic is therefore bounded by its class deadline
  instead of waiting forever on the next caller call.
* **Deficit-weighted class shares.**  Each admission round fills at most
  one chunk width of slots; classes with backlog split those slots in
  proportion to their weights via deficit round-robin (fractional
  entitlements carry over; deadline-expired pairs are taken first and
  debited against their class), so a flooding bulk tenant cannot starve
  interactive traffic, while an idle class's share is never wasted.
* **Adaptive chunk size.**  As before (§5): the padded chunk width walks
  a power-of-two ladder tracking the backlog (a small set of widths).
* **Cross-batch coalescing + dedup.**  A submitted pair whose canonical
  key is already pending or *in flight* joins the existing computation's
  waiter list; a join from a tighter-deadline class *promotes* the pair's
  deadline (never its class weight accounting).
* **Result cache.**  Consulted at submit (hits resolve immediately) and
  filled as chunks drain through ``ServingService.cache_put`` — which
  applies the cache *admission* policy (``cache_admission="reuse"``:
  don't insert predicted one-shot cold pairs).
* **Edge updates / epochs** (DESIGN.md §13).  ``submit_update`` applies
  an edge insert/delete batch: the next epoch's index is computed by
  incremental label maintenance (``QbSIndex.apply_update``) and swapped
  in under the scheduler lock (``install_index`` — the hook the replica
  tier fans a precomputed epoch out through).  Admission pins the epoch:
  every dispatched chunk records the epoch it was admitted under and its
  futures resolve from that epoch's tables (``_flight`` is keyed by
  ``(pair, epoch)``), a submission only *joins* in-flight work of the
  current epoch (an older epoch's flight is stale for it — it goes
  pending and recomputes), and cache keys carry the epoch end-to-end, so
  a stale SPG can never be served.

Dispatch reuses the service's lane machinery (``_chunks``) and its
double-buffered window across admissions.  ``ServingService.query_batch``
remains the one-shot wrapper; ``StreamingService.query_batch``
(submit-all-then-drain) matches it bit-for-bit, and with the default
single-class QoS config every pre-existing admission behavior is
unchanged.
"""
from __future__ import annotations

import heapq
import itertools
import math
import threading
from collections import deque
from dataclasses import dataclass
from typing import Iterable, Iterator, Sequence

import numpy as np

from ..core.graph import INF
from . import debug
from .clock import ManualClock, SystemClock  # noqa: F401  (re-export)
from .metrics import LatencyHistogram
from .planner import (
    LANE_GENERAL,
    LANE_LANDMARK_PAIR,
    LANE_ONE_SIDED,
    N_LANES,
    d_top_of,
    plan_from_pairs,
)
from .service import ServingService, _NO_EDGES, edge_ids_of


@dataclass(frozen=True)
class QoSClass:
    """One quality-of-service class (tenant / traffic tier).

    ``max_wait`` is the wall-clock admission deadline in seconds: a pair
    submitted under this class is dispatched to the device lanes at most
    ``max_wait`` after submission (0 = flush immediately at submit;
    ``None`` = no deadline, the pair waits for the size trigger or a
    drain).  ``weight`` is the deficit-round-robin share of admission
    slots when several classes have backlog."""

    name: str
    max_wait: float | None = None
    weight: float = 1.0

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError("QoS weight must be positive")
        if self.max_wait is not None and self.max_wait < 0:
            raise ValueError("max_wait must be >= 0 (or None)")


@dataclass(frozen=True)
class AdmissionPolicy:
    """Knobs of the streaming admission layer.

    ``chunk`` seeds the width ladder (``None``: the index's build-time
    chunk, clamped into ``[min_chunk, max_chunk]``).  With
    ``adaptive=False`` the width is pinned there — the fixed-chunk
    baseline every adaptive row benchmarks against."""

    adaptive: bool = True
    chunk: int | None = None
    min_chunk: int = 4
    max_chunk: int = 128

    def __post_init__(self):
        if self.min_chunk < 1:
            raise ValueError("min_chunk must be positive")
        # snap both bounds onto the power-of-two ladder the adaptive walk
        # uses (min up, max down — never past the caller's stated cap), so
        # halving/doubling can neither escape [min, max] nor mint widths
        # off the ladder
        object.__setattr__(self, "min_chunk",
                           1 << (self.min_chunk - 1).bit_length())
        object.__setattr__(self, "max_chunk",
                           1 << (max(1, self.max_chunk).bit_length() - 1))
        if self.max_chunk < self.min_chunk:
            raise ValueError(
                f"max_chunk rounds to {self.max_chunk} on the power-of-two "
                f"ladder, below min_chunk={self.min_chunk}")

    def initial_chunk(self, default: int) -> int:
        c = default if self.chunk is None else int(self.chunk)
        c = max(self.min_chunk, min(self.max_chunk, c))
        # both bounds sit on the ladder, so the round-up stays in range
        return 1 << (c - 1).bit_length()


class QueryFuture:
    """Handle for one submitted query; resolves when its canonical pair
    is answered (shared by every duplicate submission of that pair).
    ``qos`` records the class this submission rode in under and
    ``t_submit`` its submit instant on the injected clock — the anchor
    the per-class latency histogram measures resolution against.
    ``epoch`` is stamped at resolution with the graph epoch the answer
    was computed under (DESIGN.md §13) — ``None`` while unresolved."""

    __slots__ = ("u", "v", "qos", "t_submit", "epoch", "_stream", "_result")

    def __init__(self, u: int, v: int, stream: "StreamingService",
                 qos: str = "default", t_submit: float = 0.0):
        self.u = int(u)
        self.v = int(v)
        self.qos = qos
        self.t_submit = float(t_submit)
        self.epoch: int | None = None
        self._stream = stream
        self._result = None

    def done(self) -> bool:
        return self._result is not None

    def result(self):
        """The ``SPGResult``; drains the stream first if still unresolved
        (so ``.result()`` never deadlocks on an unflushed admission)."""
        if self._result is None:
            self._stream.drain()
        dist, eids, d_top = self._result
        from ..core.qbs import SPGResult
        return SPGResult(u=self.u, v=self.v, dist=dist, edge_ids=eids,
                         d_top=d_top)

    def _resolve(self, dist: int, eids: np.ndarray, d_top: int) -> None:
        self._result = (dist, eids, d_top)


class StreamingService:
    """Deadline/QoS-scheduled streaming front-end over a ``ServingService``.

    Event-loop style with one lock: ``submit`` buffers into per-class
    backlogs, the scheduler pumps admission rounds inline (size trigger),
    at deadlines (timer through the injected ``clock``), and on ``drain``.
    All execution policy below the admission layer (async window, cache +
    cache admission) belongs to the inner service — pass its kwargs
    through (``cache_size=``, ``cache_policy=``, ``cache_admission=`` ...).

    Lock discipline: every field named in ``_QBS_GUARDED_FIELDS`` is
    mutated only under ``with self._lock`` — enforced statically by
    qbslint rule QBS005 (internal helpers reached with the lock already
    held carry ``# qbslint: locked``) and, when ``sanitize=True`` or
    ``QBS_SANITIZE=1``, at runtime by ``serving.debug`` (guarded
    containers + an owner-tracking lock that raise
    ``ConcurrencyViolation`` on an off-lock mutation).
    """

    _QBS_GUARDED_FIELDS = (
        "_queues", "_cls_backlog", "_deficit", "_pending", "_n_pending",
        "_deadline", "_heap", "_waiting", "_flight", "_inflight", "_timer",
        "_timer_token", "_armed_for", "_chunk", "stats", "qos_stats",
        "admission_log", "lat_hist",
    )

    def __init__(self, index, *, policy: AdmissionPolicy | None = None,
                 qos: Sequence[QoSClass] | None = None, clock=None,
                 service: ServingService | None = None,
                 sanitize: bool | None = None, **service_kw):
        if service is not None and service_kw:
            raise ValueError("pass either service= or service kwargs")
        # arm the __setattr__ guard only once construction is done
        object.__setattr__(self, "_qbs", None)
        san = debug.sanitizer(sanitize)
        box = san if san is not None else debug.PLAIN
        self.service = service or ServingService(index, **service_kw)
        self.index = self.service.index
        self.policy = policy or AdmissionPolicy()
        self.clock = clock if clock is not None else SystemClock()
        self._chunk = self.policy.initial_chunk(self.service.chunk)

        self._classes: tuple[QoSClass, ...] = (
            tuple(qos) if qos else (QoSClass("default"),))
        if len({c.name for c in self._classes}) != len(self._classes):
            raise ValueError("duplicate QoS class names")
        self._cls_index = {c.name: i for i, c in enumerate(self._classes)}
        # per-class FIFO backlog of (key, seq); entries are lazily
        # invalidated (skipped) when the key's _pending seq moved on, so
        # _cls_backlog carries the exact live count per class
        self._queues: list[deque] = [
            box.deque(what=f"StreamingService._queues[{c.name}]")
            for c in self._classes]
        self._cls_backlog = box.list([0] * len(self._classes),
                                     what="StreamingService._cls_backlog")
        self._deficit = box.list([0.0] * len(self._classes),
                                 what="StreamingService._deficit")
        # canonical key -> (class idx, submit time, seq) while *pending*
        self._pending: dict[tuple[int, int], tuple[int, float, int]] = \
            box.dict(what="StreamingService._pending")
        self._n_pending = 0
        # canonical key -> earliest admission/resolution deadline while
        # the key is unresolved (pending or in flight); _heap holds
        # (deadline, seq, key) entries, stale ones dropped lazily
        self._deadline: dict[tuple[int, int], float] = \
            box.dict(what="StreamingService._deadline")
        self._heap: list[tuple[float, int, tuple[int, int]]] = \
            box.list(what="StreamingService._heap")
        self._seq = itertools.count()
        self._timer = None
        self._timer_token = None
        self._armed_for: float | None = None
        # serializes submit/drain/poll against clock-thread deadline fires
        self._lock = san.lock if san is not None else threading.RLock()
        # canonical key -> [QueryFuture, ...]; present iff *pending* (not
        # yet admitted) — admission moves the list into _flight under the
        # epoch it dispatched at
        self._waiting: dict[tuple[int, int], list[QueryFuture]] = \
            box.dict(what="StreamingService._waiting")
        # canonical key -> {admission epoch -> [QueryFuture, ...]} while
        # in flight: an update can land between two admissions of the
        # same pair, so one key can legitimately be in flight under two
        # epochs at once, each resolving against its own tables (§13)
        self._flight: dict[tuple[int, int], dict[int, list[QueryFuture]]] = \
            box.dict(what="StreamingService._flight")
        self._inflight: deque = box.deque(
            what="StreamingService._inflight")  # (plan, sel, live, epoch, out)
        self.stats = box.dict({
            "submitted": 0,        # queries accepted
            "trivial": 0,          # resolved at submit (u == v)
            "cache_hits": 0,       # resolved at submit from the cache
            "joined": 0,           # joined a pending/in-flight computation
            "admissions": 0,       # flushes dispatched (1 plan each; the
                                   # per-round detail lives in admission_log)
            "admitted_pairs": 0,   # unique pairs dispatched to lanes
            "chunks": 0,           # device chunks dispatched
            "padded_rows": 0,      # dead rows padded into those chunks
            "deadline_flushes": 0,  # flushes containing an expired pair
            "handed_off": 0,       # pending pairs exported to a peer
                                   # replica (handoff_pending)
            "updates": 0,          # epoch advances installed (§13)
        }, what="StreamingService.stats")
        # waits are wall-clock (injected-clock) seconds from submit to
        # admission — the queueing latency the deadline bounds; bounded
        # deques so a long-running service cannot grow host memory
        self.qos_stats = box.dict({
            c.name: box.dict(
                {"submitted": 0, "trivial": 0, "cache_hits": 0,
                 "joined": 0, "admitted": 0, "expired": 0,
                 "waits": box.deque(
                     maxlen=65536,
                     what=f"StreamingService.qos_stats[{c.name}].waits")},
                what=f"StreamingService.qos_stats[{c.name}]")
            for c in self._classes}, what="StreamingService.qos_stats")
        # one entry per admission round: composition + backlog snapshot
        # (the observability the fairness tests and benchmarks read)
        self.admission_log: deque = box.deque(
            maxlen=4096, what="StreamingService.admission_log")
        # per-class submit->resolution latency histograms, recorded at
        # future-resolution time on the injected clock (metrics layer,
        # DESIGN.md §12); the sanitizer probe guards their counts like
        # every other field in _QBS_GUARDED_FIELDS
        self.lat_hist = box.dict({
            c.name: LatencyHistogram(
                check=(san.check(f"StreamingService.lat_hist[{c.name}]")
                       if san is not None else None))
            for c in self._classes}, what="StreamingService.lat_hist")
        # arm the runtime sanitizer's attribute guard (None when off)
        self._qbs = san

    def __setattr__(self, name, value):
        # runtime half of QBS005 for plain-attribute rebinds (_chunk,
        # _n_pending, the timer trio): guarded containers police their
        # own mutators, this polices `self.<field> = ...`
        qbs = self.__dict__.get("_qbs")
        if qbs is not None and name in self._QBS_GUARDED_FIELDS:
            qbs.assert_owned(f"StreamingService.{name}")
        object.__setattr__(self, name, value)

    # -- introspection -------------------------------------------------------

    @property
    def chunk(self) -> int:
        """Current adaptive chunk width."""
        with self._lock:
            return self._chunk

    @property
    def n_pending(self) -> int:
        with self._lock:
            return self._n_pending

    @property
    def n_inflight(self) -> int:
        with self._lock:
            return len(self._inflight)

    @property
    def qos_classes(self) -> tuple[QoSClass, ...]:
        return self._classes

    # -- submission ----------------------------------------------------------

    def submit(self, u: int, v: int, qos: str | None = None) -> QueryFuture:
        return self.submit_batch([u], [v], qos=qos)[0]

    def submit_batch(self, us, vs, qos: str | None = None) -> list[QueryFuture]:
        """Accept a group of queries that arrived together under one QoS
        class (``None``: the default class); returns one future per query
        (duplicates share a resolution).  May fire admission rounds inline
        when the backlog reaches the chunk width or a deadline (including
        ``max_wait=0``: flush now) expires."""
        us = np.asarray(us, np.int32).reshape(-1)
        vs = np.asarray(vs, np.int32).reshape(-1)
        with self._lock:
            if qos is None:
                ci = 0
            elif qos in self._cls_index:
                ci = self._cls_index[qos]
            else:
                raise ValueError(
                    f"unknown qos class {qos!r}; configured: "
                    f"{[c.name for c in self._classes]}")
            cls = self._classes[ci]
            cstat = self.qos_stats[cls.name]
            now = self.clock.now()
            deadline = None if cls.max_wait is None else now + cls.max_wait
            cache = self.service.cache
            # the epoch this submission answers for: joins, cache lookups
            # and fresh pendings all pin to it (it can only advance under
            # this lock, so one read covers the whole batch)
            ep = self.index.epoch
            futs = []
            for u, v in zip(us.tolist(), vs.tolist()):
                fut = QueryFuture(u, v, self, qos=cls.name, t_submit=now)
                futs.append(fut)
                self.stats["submitted"] += 1
                cstat["submitted"] += 1
                if u == v:
                    fut.epoch = ep
                    fut._resolve(0, _NO_EDGES, INF)
                    self.lat_hist[cls.name].observe(0.0)
                    self.stats["trivial"] += 1
                    cstat["trivial"] += 1
                    # lane_served semantics match the one-shot service:
                    # unique per batch, so per-arrival resolutions (trivial,
                    # cache hits) count once each and re-arrivals recount
                    self.service.lane_served[0] += 1
                    continue
                key = (min(u, v), max(u, v))
                waiters = self._waiting.get(key)
                if waiters is None:
                    # in flight *at this epoch*: its pending result is
                    # exactly what this submission would compute — join.
                    # An older epoch's flight is stale for us: fall
                    # through and go pending (recompute at ep).
                    flight = self._flight.get(key)
                    if flight is not None:
                        waiters = flight.get(ep)
                if waiters is not None:      # pending or in flight: join it
                    waiters.append(fut)
                    self.stats["joined"] += 1
                    cstat["joined"] += 1
                    if deadline is not None and \
                            deadline < self._deadline.get(key, math.inf):
                        # promote the deadline (tighter class joined a
                        # pending/in-flight pair); weight accounting keeps
                        # the admitting class
                        self._deadline[key] = deadline
                        heapq.heappush(self._heap,
                                       (deadline, next(self._seq), key))
                    continue
                if cache is not None:
                    got = cache.get((key[0], key[1], ep))
                    if got is not None:
                        lane = self._lane_of(key)
                        fut.epoch = ep
                        fut._resolve(got[0], got[1],
                                     d_top_of(lane, got[0], INF))
                        self.lat_hist[cls.name].observe(0.0)
                        self.stats["cache_hits"] += 1
                        cstat["cache_hits"] += 1
                        self.service.lane_served[lane] += 1
                        continue
                self._waiting[key] = [fut]
                seq = next(self._seq)
                self._pending[key] = (ci, now, seq)
                self._queues[ci].append((key, seq))
                self._cls_backlog[ci] += 1
                self._n_pending += 1
                if deadline is not None and \
                        deadline < self._deadline.get(key, math.inf):
                    # min-merge, not overwrite: the same key may still be
                    # in flight under an older epoch with a tighter bound
                    self._deadline[key] = deadline
                    heapq.heappush(self._heap, (deadline, seq, key))
            self._pump()
            self._arm_timer()
        return futs

    def serve(self, pairs: Iterable[tuple[int, int]],
              qos: str | None = None) -> Iterator:
        """Streaming iterator entry point: consume ``(u, v)`` pairs as
        they arrive, yield ``SPGResult``s in arrival order as they
        resolve; drains whatever remains when the input ends."""
        out: deque[QueryFuture] = deque()
        for u, v in pairs:
            out.append(self.submit(u, v, qos=qos))
            while out and out[0].done():
                yield out.popleft().result()
        self.drain()
        while out:
            yield out.popleft().result()

    def query_batch(self, us, vs) -> list:
        """One-shot wrapper: submit everything, drain, collect — matches
        ``ServingService.query_batch`` bit-for-bit."""
        futs = self.submit_batch(us, vs)
        self.drain()
        return [f.result() for f in futs]

    def drain(self) -> None:
        """Admit every pending pair and resolve all in-flight work."""
        with self._lock:
            self._pump(force=True)
            self._sync_until(0)
            self._arm_timer()

    def poll(self) -> None:
        """Deadline tick for external callers: admit whatever is due at
        the current (injected) clock without submitting new traffic.  A
        no-op on an empty backlog — stale timer wakeups are safe."""
        with self._lock:
            self._pump()
            self._arm_timer()

    # -- replica handoff (ReplicaRouter rolling restarts) --------------------

    def handoff_pending(self) -> list:
        """Atomically export every *pending* (not yet admitted) pair for
        adoption by a peer replica: ``[(key, futures, qos name, t_enq,
        deadline | None), ...]``.  In-flight pairs stay — they resolve
        here on the caller's ``drain()`` — so no future is ever dropped
        or double-resolved across a handoff.  Backlog queue entries are
        left to lazy invalidation (their ``_pending`` seq is gone), the
        deadline heap likewise; ``stats['handed_off']`` counts exported
        pairs so the accounting identity stays exact:
        ``admitted_pairs == submitted - trivial - cache_hits - joined -
        handed_off``."""
        with self._lock:
            out = []
            while self._pending:
                key, (ci, t_enq, _seq) = self._pending.popitem()
                futs = self._waiting.pop(key)
                self._n_pending -= 1
                self._cls_backlog[ci] -= 1
                deadline = self._deadline.pop(key, None)
                out.append((key, futs, self._classes[ci].name, t_enq,
                            deadline))
            self.stats["handed_off"] += len(out)
            self._arm_timer()
            return out

    def adopt(self, key: tuple[int, int], futures: list, *, qos: str,
              t_enq: float, deadline: float | None = None) -> None:
        """Absorb one handed-off pair from a draining peer.  The futures
        re-target this stream (their ``result()`` drains here), keep
        their original submit times (latency spans the handoff), and the
        pair re-enters this scheduler through the same resolution paths
        a fresh submission would take: join an existing waiter list,
        resolve from this replica's cache, or go pending with the
        original deadline re-armed."""
        if qos not in self._cls_index:
            raise ValueError(
                f"cannot adopt under unknown qos class {qos!r}; replicas "
                f"must share one QoS config")
        with self._lock:
            ci = self._cls_index[qos]
            cstat = self.qos_stats[qos]
            now = self.clock.now()
            ep = self.index.epoch
            for fut in futures:
                fut._stream = self
            self.stats["submitted"] += len(futures)
            cstat["submitted"] += len(futures)
            waiters = self._waiting.get(key)
            if waiters is None:
                flight = self._flight.get(key)
                if flight is not None:         # current-epoch flight only
                    waiters = flight.get(ep)
            if waiters is not None:            # pending/in flight here: join
                waiters.extend(futures)
                self.stats["joined"] += len(futures)
                cstat["joined"] += len(futures)
                if deadline is not None and \
                        deadline < self._deadline.get(key, math.inf):
                    self._deadline[key] = deadline
                    heapq.heappush(self._heap,
                                   (deadline, next(self._seq), key))
            else:
                cache = self.service.cache
                got = (cache.get((key[0], key[1], ep))
                       if cache is not None else None)
                if got is not None:
                    lane = self._lane_of(key)
                    d_top = d_top_of(lane, got[0], INF)
                    for fut in futures:
                        fut.epoch = ep
                        fut._resolve(got[0], got[1], d_top)
                        self.lat_hist[fut.qos].observe(
                            (now - fut.t_submit) * 1e6)
                    self.stats["cache_hits"] += len(futures)
                    cstat["cache_hits"] += len(futures)
                    self.service.lane_served[lane] += len(futures)
                    self._arm_timer()
                    return
                self._waiting[key] = list(futures)
                seq = next(self._seq)
                self._pending[key] = (ci, t_enq, seq)
                self._queues[ci].append((key, seq))
                self._cls_backlog[ci] += 1
                self._n_pending += 1
                # one creator per fresh pair, like submit_batch duplicates
                self.stats["joined"] += len(futures) - 1
                cstat["joined"] += len(futures) - 1
                if deadline is not None and \
                        deadline < self._deadline.get(key, math.inf):
                    self._deadline[key] = deadline
                    heapq.heappush(self._heap, (deadline, seq, key))
            self._pump()
            self._arm_timer()

    def export_cache(self, pred=None, *, remove: bool = False) -> list:
        """Export packed result-cache entries under the scheduler lock
        (``ResultCache.export_packed``): the router's warm-handoff hook,
        so cache residency moves with key ownership on drain/restore
        instead of re-warming from cold.  ``pred`` filters on the full
        epoched key; ``remove=True`` makes it a move."""
        with self._lock:
            cache = self.service.cache
            if cache is None:
                return []
            return cache.export_packed(pred, remove=remove)

    def import_cache(self, entries) -> None:
        """Absorb packed cache entries exported by a peer replica."""
        with self._lock:
            cache = self.service.cache
            if cache is not None:
                cache.import_packed(entries)

    # -- dynamic updates (DESIGN.md §13) -------------------------------------

    def submit_update(self, inserts=None, deletes=None, *,
                      churn_threshold: float = 0.5):
        """Apply one edge insert/delete batch to the served graph and
        advance the epoch.  The next epoch's index is computed *outside*
        the scheduler lock (incremental label maintenance —
        ``QbSIndex.apply_update`` — can take many milliseconds; serving
        keeps running on the current epoch meanwhile), then swapped in
        atomically via ``install_index``.  Returns the new index.

        Consistency: chunks already dispatched resolve under their
        admission epoch (their device programs hold the old tables);
        pairs still pending admit under the new epoch at their next
        flush; the caches never cross epochs (keys carry the epoch)."""
        new = self.index.apply_update(inserts=inserts, deletes=deletes,
                                      churn_threshold=churn_threshold)
        self.install_index(new)
        return new

    def install_index(self, index) -> None:
        """Install a pre-computed next-epoch index under the scheduler
        lock — the fan-out hook ``ReplicaRouter.apply_update`` uses to
        advance every replica to the *same* index without computing the
        update batch N times."""
        with self._lock:
            self.service.install_index(index)
            self.index = index
            self.stats["updates"] += 1

    def close(self) -> None:
        """Drain outstanding work and disarm the deadline timer, so no
        clock-thread callback outlives the service.  Idempotent, and the
        service stays usable — a later ``submit`` re-arms the timer."""
        self.drain()
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            self._timer_token = None
            self._armed_for = None

    def __enter__(self) -> "StreamingService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- the scheduler -------------------------------------------------------

    def _adapt_chunk(self, backlog: int) -> None:  # qbslint: locked
        """Track the arrival rate: double while the backlog outruns the
        width, halve while it would fit in half of it."""
        if not self.policy.adaptive or backlog <= 0:
            return
        c = self._chunk
        while backlog > c and c < self.policy.max_chunk:
            c <<= 1
        while backlog <= (c >> 1) and c > self.policy.min_chunk:
            c >>= 1
        self._chunk = c

    def _pump(self, force: bool = False) -> None:  # qbslint: locked
        """The admission loop.  Triggers: an expired deadline (flush the
        overdue pairs now, plus a weighted fill of the rest of the
        round), the size trigger (backlog reached the chunk width), or
        ``force`` (drain).  Once *any* trigger fires, scheduling rounds
        repeat until the backlog drains — the §5 flush-everything
        semantics, so a burst's sub-chunk tail is never stranded behind
        the size trigger — with each round's slots still split by class
        weight: under contention the weights shape dispatch *order*,
        never total work.  The rounds of one flush dispatch as a single
        dense planner batch (``_admit_flush``).  A deadline-triggered
        flush also syncs the in-flight window so the overdue futures
        *resolve* within their bound, not just dispatch."""
        now = self.clock.now()
        expired, expired_inflight = self._pop_expired(now)
        if not (force or expired or self._n_pending >= self._chunk):
            if expired_inflight:
                self._sync_until(0)
            return
        self._adapt_chunk(self._n_pending + len(expired))
        # rounds are the *scheduling* unit (weighted slot accounting,
        # admission_log); the whole flush then plans and dispatches as
        # ONE batch so lanes pack densely across round boundaries — a
        # mixed-lane flush pays per-lane padding once, not per round
        rounds: list[tuple[list, int]] = []
        batch = expired + self._drr_select(self._chunk - len(expired))
        while batch:
            self._log_round(batch, now, n_expired=len(expired))
            rounds.append((batch, len(expired)))
            expired = []
            batch = self._drr_select(self._chunk)
        if rounds:
            self._admit_flush(rounds, now)
        if (rounds and rounds[0][1]) or expired_inflight:
            self._sync_until(0)

    def _pop_expired(self, now: float):  # qbslint: locked
        """Pop every deadline due at ``now``.  Returns the expired
        *pending* entries (removed from the backlog, ready to admit) and
        whether any expired key is already in flight (its round must end
        in a full sync so the overdue future resolves)."""
        expired, expired_inflight = [], False
        while self._heap and self._heap[0][0] <= now:
            dl, _, key = heapq.heappop(self._heap)
            if self._deadline.get(key) != dl:
                continue                          # stale (promoted/resolved)
            del self._deadline[key]
            ent = self._pending.get(key)
            if ent is not None:
                ci, t_enq, _ = ent
                del self._pending[key]
                self._n_pending -= 1
                self._cls_backlog[ci] -= 1
                # charged outside its share; debt is clamped to one round
                # so a long quiet trickle of expiries cannot bank enough
                # debt to suppress the class's weighted share for ages
                self._deficit[ci] = max(self._deficit[ci] - 1.0,
                                        -float(self._chunk))
                self.qos_stats[self._classes[ci].name]["expired"] += 1
                expired.append((key, ci, t_enq))
            elif key in self._flight:
                expired_inflight = True           # joined an in-flight pair
        return expired, expired_inflight

    def _take_from(self, ci: int):  # qbslint: locked
        """Pop the oldest valid pending key of class ``ci`` (skipping
        entries invalidated by expiry-admission or re-submission), or
        None when the class backlog is empty."""
        q = self._queues[ci]
        while q:
            key, seq = q.popleft()
            ent = self._pending.get(key)
            if ent is not None and ent[2] == seq:
                del self._pending[key]
                self._n_pending -= 1
                self._cls_backlog[ci] -= 1
                # the deadline entry stays until *resolution*: if this
                # pair lingers un-synced in the async window, the timer
                # still fires and syncs it within its bound
                return (key, ci, ent[1])
        return None

    def _drr_select(self, budget: int) -> list:  # qbslint: locked
        """Deficit-weighted round-robin: split ``budget`` admission slots
        across the classes that have backlog, in proportion to their
        weights.  Fractional entitlements accumulate in per-class deficit
        counters (so small weights still get served), a class's deficit
        resets when its backlog empties (no hoarding while idle), and any
        slots left by short queues top up from the remaining classes —
        a full round is never under-filled while backlog exists."""
        sel: list = []
        if budget <= 0 or self._n_pending == 0:
            return sel
        active = [i for i, n in enumerate(self._cls_backlog) if n > 0]
        total_w = sum(self._classes[i].weight for i in active)
        for i in active:
            self._deficit[i] += budget * self._classes[i].weight / total_w
        empty = set()
        progress = True
        while len(sel) < budget and progress and self._n_pending:
            progress = False
            for i in active:
                if len(sel) >= budget:
                    break
                if i in empty or self._deficit[i] < 1.0:
                    continue
                got = self._take_from(i)
                if got is None:
                    empty.add(i)
                    self._deficit[i] = 0.0
                    continue
                sel.append(got)
                self._deficit[i] -= 1.0
                progress = True
        # top-up: deficits all fractional (or negative after expiry debits)
        # but slots and backlog remain — grant the largest-deficit class
        while len(sel) < budget and self._n_pending:
            live = [i for i in active if i not in empty]
            if not live:
                break
            i = max(live, key=lambda j: self._deficit[j])
            got = self._take_from(i)
            if got is None:
                empty.add(i)
                self._deficit[i] = 0.0
                continue
            sel.append(got)
            self._deficit[i] = max(self._deficit[i] - 1.0,
                                   -float(self._chunk))
        # no hoarding while idle: a class whose backlog just drained must
        # not bank this round's unspent entitlement for a later flood
        # (the in-loop resets only fire when a take is *attempted*)
        for i in active:
            if self._cls_backlog[i] == 0:
                self._deficit[i] = 0.0
        return sel

    def _log_round(self, batch: list, now: float, n_expired: int) -> None:  # qbslint: locked
        """One admission_log entry per scheduling round, recorded at
        selection time so the backlog snapshot is the round's live
        leftover — the signal the fairness analyses key on."""
        per_class: dict[str, int] = {}
        for _, ci, _ in batch:
            name = self._classes[ci].name
            per_class[name] = per_class.get(name, 0) + 1
        self.admission_log.append({
            "t": now, "n": len(batch), "chunk": self._chunk,
            "expired": n_expired, "per_class": per_class,
            # live counts, not queue lengths: lazily-invalidated entries
            # must not make an idle class look contended
            "backlog": {c.name: self._cls_backlog[i]
                        for i, c in enumerate(self._classes)},
        })

    def _admit_flush(self, rounds: list, now: float) -> None:  # qbslint: locked
        """Dispatch a whole flush — the concatenated scheduling rounds,
        each ``[(key, class idx, submit time), ...]`` — as one planner
        batch through the service's lane machinery at the current chunk
        width, keeping at most ``async_depth`` chunks un-synced in
        flight.  Row order is round order, so the weighted schedule
        decides intra-lane dispatch (and thus resolution) order.

        Epoch pinning (§13): every key admitted here moves from
        ``_waiting`` into ``_flight[key][epoch]`` and every dispatched
        chunk records the epoch — the device programs capture the
        current index's tables at dispatch, and an ``install_index``
        racing this flush is excluded by the scheduler lock, so chunk
        results and the recorded epoch can never disagree."""
        svc = self.service
        ep = self.index.epoch
        batch = [entry for b, _ in rounds for entry in b]
        for key, _, _ in batch:
            self._flight.setdefault(key, {})[ep] = self._waiting.pop(key)
        cu = np.fromiter((k[0][0] for k in batch), np.int32, len(batch))
        cv = np.fromiter((k[0][1] for k in batch), np.int32, len(batch))
        cls = np.fromiter((k[1] for k in batch), np.int16, len(batch))
        plan = plan_from_pairs(cu, cv, self.index._is_landmark_np, cls=cls)
        self.stats["admissions"] += 1
        self.stats["admitted_pairs"] += plan.n_unique
        if any(n_expired for _, n_expired in rounds):
            self.stats["deadline_flushes"] += 1
        # per-class accounting reads the *plan's* class tags — the thing
        # the lanes actually dispatch — so a planner cls-propagation bug
        # surfaces here (waits still need the submit times from batch)
        for (_, _, t_enq), ci in zip(batch, plan.cls.tolist()):
            cstat = self.qos_stats[self._classes[ci].name]
            cstat["admitted"] += 1
            cstat["waits"].append(now - t_enq)
        for k in range(1, N_LANES):
            svc.lane_served[k] += int(plan.lanes[k].size)
        for sel, live, dispatch in svc._chunks(plan, chunk=self._chunk):
            self._inflight.append((plan, sel, live, ep, dispatch()))
            self.stats["chunks"] += 1
            self.stats["padded_rows"] += sel.shape[0] - live
            self._sync_until(svc.async_depth - 1)

    # -- deadline timer ------------------------------------------------------

    def _earliest_deadline(self) -> float | None:  # qbslint: locked
        heap = self._heap
        while heap and self._deadline.get(heap[0][2]) != heap[0][0]:
            heapq.heappop(heap)                   # drop stale entries
        return heap[0][0] if heap else None

    def _arm_timer(self) -> None:  # qbslint: locked
        due = self._earliest_deadline()
        if due == self._armed_for:
            return
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        self._armed_for = due
        if due is not None:
            # the token identifies THIS arming: a SystemClock timer that
            # already fired and is waiting on the lock while another
            # thread re-arms must not clobber the newer timer's tracking
            token = object()
            self._timer_token = token
            self._timer = self.clock.call_at(
                due, lambda: self._on_timer(token))

    def _on_timer(self, token) -> None:
        with self._lock:
            if token is self._timer_token:
                self._timer = None
                self._armed_for = None
                self._timer_token = None
            # stale fires still pump: the wakeup is an idempotent poll
            self._pump()
            self._arm_timer()

    # -- resolution ----------------------------------------------------------

    def _sync_until(self, limit: int) -> None:  # qbslint: locked
        now = self.clock.now()
        while len(self._inflight) > limit:
            plan, sel, live, ep, out = self._inflight.popleft()
            d, row_eids = edge_ids_of(*out, live)
            for k in range(live):
                row = int(sel[k])
                key = (int(plan.cu[row]), int(plan.cv[row]))
                eids = row_eids[k]
                eids.flags.writeable = False   # shared: waiters + cache
                dist = int(d[k])
                d_top = d_top_of(int(plan.lane[row]), dist, INF)
                flight = self._flight[key]
                for fut in flight.pop(ep):
                    fut.epoch = ep
                    fut._resolve(dist, eids, d_top)
                    # resolution-time latency on the injected clock: under
                    # ManualClock this is a pure function of the trace
                    self.lat_hist[fut.qos].observe(
                        (now - fut.t_submit) * 1e6)
                if not flight:
                    del self._flight[key]
                if key not in self._waiting and key not in self._flight:
                    # the pair may have been re-submitted (pending at a
                    # newer epoch) or still be in flight under another
                    # epoch — its deadline must survive this resolution
                    self._deadline.pop(key, None)
                self.service.cache_put((key[0], key[1], ep), (dist, eids))

    def _lane_of(self, key: tuple[int, int]) -> int:
        """Scalar lane classification for submit-time (cache-hit)
        resolutions — two bool lookups, no array construction, because
        this sits on the hot path the cache exists to make fast.  Cached
        keys are never trivial (u == v resolves before the cache)."""
        is_l = self.index._is_landmark_np
        lu = bool(is_l[key[0]])
        lv = bool(is_l[key[1]])
        if lu and lv:
            return LANE_LANDMARK_PAIR
        if lu or lv:
            return LANE_ONE_SIDED
        return LANE_GENERAL
