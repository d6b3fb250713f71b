"""Wall time of ``QbSIndex.build`` on the graph on the device,
synchronised, after one warm-up build of the same graph, in s."""


def read(raw):
    return raw.get("build_s")
