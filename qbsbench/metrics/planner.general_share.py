"""Share of the unique pairs the planner routed to the general lane over
the window (``ServingService.lane_served``), in %."""


def read(raw):
    lanes = raw.get("lane_served")
    if not lanes or not sum(lanes):
        return None
    return 100.0 * lanes[3] / sum(lanes)
