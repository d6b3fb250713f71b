"""Observability layer for the serving tier (DESIGN.md §12).  A copy of
``repro.serving.metrics`` (host-only; the port imports nothing of the
reference package).

The scheduler already *has* the numbers — ``StreamingService.stats`` /
``qos_stats``, ``admission_log`` round compositions, ``ResultCache``
hit/eviction/byte counters — but they live as internal fields read by
tests.  This module makes them operational:

* ``LatencyHistogram`` — fixed log2-bucket (microsecond) histogram of
  submit-to-resolution latency, recorded per QoS class at *future
  resolution time* on the injectable clock (``serving.clock``), so under
  ``ManualClock`` every count is a deterministic function of the trace
  and p50/p99 become gateable CI numbers (``benchmarks/trace_replay.py``
  + ``scripts/bench_gate.py --p99-ceiling-us``).  Counts are plain
  Python ints (no numpy scalars on the host path — QBS007's spirit) and
  quantiles return the conservative *upper edge* of the hit bucket.
* ``MetricsRegistry`` — named sources (``StreamingService`` instances,
  e.g. every replica of a ``ReplicaRouter``) snapshotted into one
  structured dict for tests and one Prometheus-style text exposition for
  scraping.  Every read happens under the owning service's lock, so the
  registry can be scraped while submit/timer threads run — the QBS005
  discipline extends to readers.
* ``serve_metrics`` — the scrape endpoint: a stdlib ``http.server``
  serving ``GET /metrics`` on a daemon thread (``launch/serve.py
  --metrics-port``).  No wall-clock reads here: rendering only snapshots
  counters, so the module stays QBS002-clean.
"""
from __future__ import annotations

import http.server
import math
import threading
from typing import Callable, Iterable

# bucket 0: us < 1; bucket b in [1, 31]: 2^(b-1) <= us < 2^b;
# bucket 32: us >= 2^31 (overflow).  Upper edges are 2^b; the overflow
# bucket's is +inf — a quantile landing there reports inf rather than
# inventing a finite number.
N_BUCKETS = 33
_OVERFLOW = N_BUCKETS - 1


def bucket_of(us: float) -> int:
    """Bucket index for a latency in microseconds (log2 edges)."""
    if us < 1.0:
        return 0
    return min(int(us).bit_length(), _OVERFLOW)


def bucket_upper_us(i: int) -> float:
    """Exclusive upper edge of bucket ``i`` in microseconds."""
    return math.inf if i >= _OVERFLOW else float(1 << i)


class LatencyHistogram:
    """Fixed log2-bucket latency histogram (microseconds).

    ``check`` is an optional zero-arg callable asserted before every
    mutation — the runtime sanitizer's lock-ownership probe
    (``serving.debug.Sanitizer.check``), wired in by the owning
    ``StreamingService`` so off-lock observations fail loudly under
    ``QBS_SANITIZE=1``."""

    __slots__ = ("counts", "total", "sum_us", "_check")

    def __init__(self, check: Callable[[], None] | None = None):
        self.counts: list[int] = [0] * N_BUCKETS
        self.total = 0
        self.sum_us = 0.0
        self._check = check

    def observe(self, us: float) -> None:
        if self._check is not None:
            self._check()
        us = float(us)
        self.counts[bucket_of(us)] += 1
        self.total += 1
        self.sum_us += us

    def quantile(self, q: float) -> float:
        """Conservative quantile: the upper edge of the bucket holding
        the rank-``ceil(q * total)`` observation (0.0 when empty)."""
        if self.total == 0:
            return 0.0
        rank = min(self.total, max(1, math.ceil(q * self.total)))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                return bucket_upper_us(i)
        return math.inf                      # unreachable: cum == total

    def snapshot(self) -> dict:
        return {
            "counts": list(self.counts),
            "total": self.total,
            "sum_us": self.sum_us,
            "p50_us": self.quantile(0.50),
            "p99_us": self.quantile(0.99),
        }


class MetricsRegistry:
    """Named serving sources -> one structured snapshot / text exposition.

    ``register`` accepts anything with the ``StreamingService`` counter
    surface (``stats``, ``qos_stats``, ``lat_hist``, ``admission_log``,
    ``service.cache``, ``_lock``); a ``ReplicaRouter`` registers each
    replica under its own name so per-replica partitioning stays visible
    in the scrape."""

    def __init__(self):
        self._sources: list[tuple[str, object]] = []
        self._reg_lock = threading.Lock()

    def register(self, name: str, service) -> None:
        with self._reg_lock:
            if any(n == name for n, _ in self._sources):
                raise ValueError(f"duplicate metrics source name {name!r}")
            self._sources.append((name, service))

    def sources(self) -> list[tuple[str, object]]:
        with self._reg_lock:
            return list(self._sources)

    def _snapshot_one(self, st) -> dict:
        # one consistent cut per source: everything below reads under the
        # service's own lock, the same lock its mutators hold (QBS005)
        with st._lock:
            qos = {}
            for name, cs in st.qos_stats.items():
                qos[name] = {k: v for k, v in cs.items() if k != "waits"}
                qos[name]["n_waits"] = len(cs["waits"])
            rounds = list(st.admission_log)
            out = {
                "stats": dict(st.stats),
                "qos": qos,
                "latency_us": {name: h.snapshot()
                               for name, h in st.lat_hist.items()},
                "admission": {
                    "rounds": len(rounds),
                    "expired_rounds": sum(
                        1 for r in rounds if r["expired"]),
                    "slots": sum(r["n"] for r in rounds),
                },
                "chunk": st._chunk,
                "n_pending": st._n_pending,
                "n_inflight": len(st._inflight),
            }
        cache = st.service.cache
        if cache is not None:
            out["cache"] = {
                "hits": cache.hits, "misses": cache.misses,
                "evictions": cache.evictions, "bytes": cache.bytes,
                "entries": len(cache),
            }
        return out

    def snapshot(self) -> dict:
        """Structured dict, one entry per registered source — the form
        the tests assert against."""
        return {name: self._snapshot_one(st) for name, st in self.sources()}

    def render_text(self) -> str:
        """Prometheus-style text exposition (counters + cumulative-``le``
        histogram series) built from ``snapshot``."""
        snap = self.snapshot()
        lines: list[str] = []
        for name, s in sorted(snap.items()):
            lab = f'service="{name}"'
            for k, v in sorted(s["stats"].items()):
                lines.append(f"qbs_{k}_total{{{lab}}} {v}")
            lines.append(f"qbs_pending{{{lab}}} {s['n_pending']}")
            lines.append(f"qbs_inflight{{{lab}}} {s['n_inflight']}")
            lines.append(f"qbs_chunk_width{{{lab}}} {s['chunk']}")
            for k in ("rounds", "expired_rounds", "slots"):
                lines.append(
                    f"qbs_admission_{k}_total{{{lab}}} {s['admission'][k]}")
            for cls, cs in sorted(s["qos"].items()):
                clab = f'{lab},qos="{cls}"'
                for k, v in sorted(cs.items()):
                    lines.append(f"qbs_qos_{k}_total{{{clab}}} {v}")
            for cls, h in sorted(s["latency_us"].items()):
                clab = f'{lab},qos="{cls}"'
                cum = 0
                for i, c in enumerate(h["counts"]):
                    cum += c
                    edge = bucket_upper_us(i)
                    le = "+Inf" if math.isinf(edge) else f"{int(edge)}"
                    lines.append(
                        f'qbs_latency_us_bucket{{{clab},le="{le}"}} {cum}')
                lines.append(f"qbs_latency_us_count{{{clab}}} {h['total']}")
                lines.append(f"qbs_latency_us_sum{{{clab}}} {h['sum_us']}")
            if "cache" in s:
                for k, v in sorted(s["cache"].items()):
                    lines.append(f"qbs_cache_{k}{{{lab}}} {v}")
        return "\n".join(lines) + "\n"


class _MetricsHandler(http.server.BaseHTTPRequestHandler):
    registry: MetricsRegistry = None  # bound per server class below

    def do_GET(self):                               # noqa: N802 (stdlib API)
        if self.path.rstrip("/") not in ("", "/metrics"):
            self.send_error(404)
            return
        body = self.registry.render_text().encode()
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):                   # quiet scrapes
        pass


def serve_metrics(registry: MetricsRegistry, port: int = 0,
                  host: str = "127.0.0.1") -> http.server.ThreadingHTTPServer:
    """Start the scrape endpoint on a daemon thread; returns the server
    (``server.server_address[1]`` is the bound port — ``port=0`` picks an
    ephemeral one; stop with ``server.shutdown()``)."""
    handler = type("BoundMetricsHandler", (_MetricsHandler,),
                   {"registry": registry})
    server = http.server.ThreadingHTTPServer((host, port), handler)
    server.daemon_threads = True
    thread = threading.Thread(target=server.serve_forever,
                              name="qbs-metrics", daemon=True)
    thread.start()
    return server


def merged_latency(hists: Iterable[LatencyHistogram]) -> LatencyHistogram:
    """Sum several histograms (e.g. one QoS class across all replicas)
    into a fresh one — bucket edges are shared, so merging is exact."""
    out = LatencyHistogram()
    for h in hists:
        for i, c in enumerate(h.counts):
            out.counts[i] += c
        out.total += h.total
        out.sum_us += h.sum_us
    return out
