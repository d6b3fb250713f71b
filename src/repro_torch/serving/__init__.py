"""Serving: the host-side planner, the chunked execution service with its
result cache, the streaming QoS scheduler, the replica tier, the metrics
layer, and the serve steps (the SPG step and the LM prefill/decode units
with ``greedy_generate``)."""
from .clock import ManualClock, SystemClock
from .metrics import (
    LatencyHistogram,
    MetricsRegistry,
    merged_latency,
    serve_metrics,
)
from .planner import (
    LANE_GENERAL,
    LANE_LANDMARK_PAIR,
    LANE_NAMES,
    LANE_ONE_SIDED,
    LANE_TRIVIAL,
    QueryPlan,
    merge_plans,
    plan_from_pairs,
    plan_queries,
)
from .replicas import ReplicaRouter
from .serve_step import (
    greedy_generate,
    make_decode_step,
    make_prefill_step,
    make_spg_serve_step,
    serve_spg_batch,
)
from .service import ResultCache, ServingService, round_chunk_to_shards
from .stream import AdmissionPolicy, QoSClass, QueryFuture, StreamingService

__all__ = [
    "AdmissionPolicy",
    "LatencyHistogram",
    "ManualClock",
    "MetricsRegistry",
    "QoSClass",
    "ReplicaRouter",
    "SystemClock",
    "LANE_GENERAL",
    "LANE_LANDMARK_PAIR",
    "LANE_NAMES",
    "LANE_ONE_SIDED",
    "LANE_TRIVIAL",
    "QueryFuture",
    "QueryPlan",
    "ResultCache",
    "ServingService",
    "StreamingService",
    "greedy_generate",
    "make_decode_step",
    "make_prefill_step",
    "make_spg_serve_step",
    "merge_plans",
    "merged_latency",
    "plan_from_pairs",
    "plan_queries",
    "round_chunk_to_shards",
    "serve_metrics",
    "serve_spg_batch",
]
