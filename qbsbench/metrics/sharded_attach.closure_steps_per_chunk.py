"""Closure steps of the sharded general lane's attach kernels (counter
``sharded.closure_steps``: one per step, every landmark and both sides at
once) per sharded general chunk (span ``qbs.sharded.serve_step``) of the
profiled slice. None where the program has no tracer, no sharded chunk or
no such counter: a program without the kernels, or the plain loop on the
CPU, counts none."""


def read(raw):
    try:
        from repro_torch import trace
    except ImportError:
        return None
    r = trace.report()
    chunk = r["spans"].get("sharded.serve_step")
    steps = r["counters"].get("sharded.closure_steps")
    if not chunk or steps is None:
        return None
    return steps / chunk["calls"]
