"""Steps of the anchor-chain closure in ``_side_attach``, both sides (counter
``search.closure_steps``), per general chunk of the profiled slice. None
where the program has no tracer."""


def read(raw):
    try:
        from repro_torch import trace
    except ImportError:
        return None
    r = trace.report()
    chunk = r["spans"].get("serve_step")
    if not chunk:
        return None
    return r["counters"].get("search.closure_steps", 0) / chunk["calls"]
