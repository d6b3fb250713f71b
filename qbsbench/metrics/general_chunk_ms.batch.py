"""Mean wall time of one general-lane chunk, in ms: ``QbSIndex.serve_step``
with a synchronise after it, over the window's general chunks outside the
profiled slice."""


def read(raw):
    times = raw.get("general_chunk_s")
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
