"""Share of the general lane's rows that ``guided_search`` hands to the
recover search (counters ``search.recover_rows`` over ``search.rows``) in
the profiled slice, in %. None where the program has no tracer."""


def read(raw):
    try:
        from repro_torch import trace
    except ImportError:
        return None
    counters = trace.report()["counters"]
    rows = counters.get("search.rows")
    if not rows:
        return None
    return 100.0 * counters.get("search.recover_rows", 0) / rows
