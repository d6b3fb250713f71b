"""Host wall time of ``serving/service.py::edge_ids_of``, the copy of one
drained chunk's answers to the host (span ``qbs.drain``), per call in the
profiled slice, in ms. None where the program has no tracer."""


def read(raw):
    try:
        from repro_torch import trace
    except ImportError:
        return None
    drain = trace.report()["spans"].get("drain")
    if not drain:
        return None
    return drain["host_ms"] / drain["calls"]
