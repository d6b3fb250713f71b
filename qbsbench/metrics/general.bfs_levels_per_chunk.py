"""Levels of ``bidirectional_bfs`` (counter ``search.bfs_levels``, one per
pass of its loop) per general chunk of the profiled slice. None where the
program has no tracer."""


def read(raw):
    try:
        from repro_torch import trace
    except ImportError:
        return None
    r = trace.report()
    chunk = r["spans"].get("serve_step")
    if not chunk:
        return None
    return r["counters"].get("search.bfs_levels", 0) / chunk["calls"]
