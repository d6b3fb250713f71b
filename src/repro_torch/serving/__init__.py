"""SPG serving: the host-side planner and the chunked execution service."""
from .planner import (
    LANE_GENERAL,
    LANE_LANDMARK_PAIR,
    LANE_NAMES,
    LANE_ONE_SIDED,
    LANE_TRIVIAL,
    QueryPlan,
    plan_queries,
)
from .service import ServingService

__all__ = ["LANE_GENERAL", "LANE_LANDMARK_PAIR", "LANE_NAMES", "LANE_ONE_SIDED",
           "LANE_TRIVIAL", "QueryPlan", "ServingService", "plan_queries"]
