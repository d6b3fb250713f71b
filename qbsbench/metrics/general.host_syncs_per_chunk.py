"""Points at which the host waits on the device in ``guided_search`` and its
stages (counter ``search.host_syncs``) per general chunk of the profiled
slice. None where the program has no tracer."""


def read(raw):
    try:
        from repro_torch import trace
    except ImportError:
        return None
    r = trace.report()
    chunk = r["spans"].get("serve_step")
    if not chunk:
        return None
    return r["counters"].get("search.host_syncs", 0) / chunk["calls"]
