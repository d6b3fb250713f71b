"""Device time of one general chunk, ``QbSIndex.serve_step`` (span
``qbs.serve_step``), from CUDA events on the stream at its entry and exit,
per general chunk of the profiled slice, in ms. No value without CUDA
events (a CPU run). None where the program has no tracer."""


def read(raw):
    try:
        from repro_torch import trace
    except ImportError:
        return None
    chunk = trace.report()["spans"].get("serve_step")
    if not chunk or chunk["device_ms"] is None:
        return None
    return chunk["device_ms"] / chunk["calls"]
