"""The QbS deployment: the configuration's graph, handed to the port as an
edge list, and a ``QbSIndex`` built on it with the configuration's
landmark count, relay backend and chunk.

``from_edges_s`` is the host's CSR construction (``core.graph.from_edges``)
and ``build_s`` the wall time of ``QbSIndex.build`` after it on the device
(landmark selection, the labelling, the packed tables, the relay
engines), synchronised; both are per-layer metrics, read in a traced run
only.  A traced run builds the index twice and times the second build: a
process's first build also pays for loading kernels and libraries and for
growing the CUDA allocator, which varies from process to process by more
than the build itself.  A run with tracing off builds once.  In a traced
run this module also wraps, while the run lasts, the program's calls that
the per-layer readers read: ``build_labelling`` where ``core/qbs.py`` looks it
up (``labelling_s``), ``QbSIndex.serve_step`` (general chunks, and their
wall time with a synchronise outside the profiled slice), the landmark
lane steps and the host drain (spans), and ``kernels.ops.hybrid_relay``
(the bytes of each call inside the profiled slice).
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core import QbSIndex, from_edges
from repro_torch.core import qbs as core_qbs
from repro_torch.kernels import ops
from repro_torch.serving import service as serving_service
from repro_torch.serving import stream as serving_stream

from qbsbench import graphgen
from qbsbench.peaks import hybrid_relay_call_bytes


class QbsSystem:
    """What the drivers and the harness read of a deployment: its edge
    list, the index and its landmarks (``landmarks`` in any order)."""

    def __init__(self, edges: np.ndarray, n_vertices: int, index, landmarks):
        self.edges = edges
        self.n_vertices = n_vertices
        self.index = index
        self.is_landmark = np.zeros((n_vertices,), bool)
        self.is_landmark[np.asarray(landmarks)] = True
        self.landmarks = np.flatnonzero(self.is_landmark).astype(np.int32)

    @staticmethod
    def launches() -> dict:
        return dict(ops.LAUNCHES)

    def release(self) -> None:
        self.index = None


def _instrument_build(rec, owner, name: str) -> None:
    """Time the labelling, ``owner.name``, into ``labelling_s``."""
    def make(orig):
        def labelling(*a, **kw):
            t0 = time.perf_counter()
            with rec.span("build_labelling"):
                out = orig(*a, **kw)
                rec.synchronize()
            rec.raw["labelling_s"] = time.perf_counter() - t0
            return out
        return labelling
    rec.patch(owner, name, make)


def _instrument_serving(rec, index_cls) -> None:
    raw = rec.raw

    def general(orig):
        def serve_step(index, us, vs):
            with rec.span("general_step"):
                raw["general_chunks"] = raw.get("general_chunks", 0) + 1
                if rec.in_slice:
                    return orig(index, us, vs)
                t0 = time.perf_counter()
                out = orig(index, us, vs)
                rec.synchronize()
                raw.setdefault("general_chunk_s", []).append(time.perf_counter() - t0)
                return out
        return serve_step

    def spanned(name):
        def make(orig):
            def call(*a, **kw):
                with rec.span(name):
                    return orig(*a, **kw)
            return call
        return make

    def relay(orig):
        def hybrid_relay(*a):
            if rec.in_slice:
                raw["relay_bytes"] = raw.get("relay_bytes", 0) + hybrid_relay_call_bytes(*a)
                raw["relay_calls"] = raw.get("relay_calls", 0) + 1
            with rec.span("hybrid_relay"):
                return orig(*a)
        return hybrid_relay

    rec.patch(index_cls, "serve_step", general)
    rec.patch(index_cls, "landmark_pair_step", spanned("landmark_pair_step"))
    rec.patch(index_cls, "landmark_onesided_step", spanned("landmark_onesided_step"))
    rec.patch(serving_service, "edge_ids_of", spanned("drain"))
    rec.patch(serving_stream, "edge_ids_of", spanned("drain"))
    rec.patch(ops, "hybrid_relay", relay)


def build_index(rec, build, labelling: tuple, index_cls):
    """``build()``, synchronised, into ``build_s``; a traced run builds
    twice, frees the first index and times the second, and instruments
    the labelling (``labelling``: the owner and name it is looked up by)
    and the serving calls of ``index_cls``."""
    def timed():
        t0 = time.perf_counter()
        with rec.span("build"):
            index = build()
            rec.synchronize()
        return index, time.perf_counter() - t0

    if rec.trace:
        timed()             # warm-up: loads every kernel, fills the allocator
        _instrument_build(rec, *labelling)
    index, rec.raw["build_s"] = timed()
    if rec.trace:
        _instrument_serving(rec, index_cls)
    return index


def setup(config: dict, seed: int, device, rec) -> QbsSystem:
    ix = config["index"]
    edges, n = graphgen.generate(config["graph"])
    t0 = time.perf_counter()
    g = from_edges(edges, n, device=device)
    rec.synchronize()
    rec.raw["from_edges_s"] = time.perf_counter() - t0
    index = build_index(
        rec, lambda: QbSIndex.build(g, n_landmarks=int(ix["n_landmarks"]),
                                    backend=ix["backend"], chunk=int(ix["chunk"]),
                                    device=device),
        (core_qbs, "build_labelling"), QbSIndex)
    return QbsSystem(edges, n, index, index.scheme.landmarks.cpu().numpy())
