"""Device time of ``reverse_search`` and the selection of its rows in
``guided_search`` (span ``qbs.search.reverse``) per general chunk of the
profiled slice, in ms. A stage that did not run in a chunk counts 0; no
value without the chunks' CUDA events (a CPU run). None where the program
has no tracer."""


def read(raw):
    try:
        from repro_torch import trace
    except ImportError:
        return None
    spans = trace.report()["spans"]
    chunk = spans.get("serve_step")
    if not chunk or chunk["device_ms"] is None:
        return None
    return (spans.get("search.reverse", {}).get("device_ms") or 0.0) / chunk["calls"]
