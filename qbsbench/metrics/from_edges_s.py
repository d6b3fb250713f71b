"""Wall time of the host's CSR construction, ``core.graph.from_edges``,
over the configuration's edge list and its copy to the device, in s."""


def read(raw):
    return raw.get("from_edges_s")
