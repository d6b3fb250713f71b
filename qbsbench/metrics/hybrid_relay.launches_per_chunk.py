"""``hybrid_relay`` launches (``kernels.ops.LAUNCHES``) over the window per
general chunk dispatched."""


def read(raw):
    n = raw.get("general_chunks")
    launches = raw.get("launches")
    if not n or launches is None:
        return None
    return launches.get("hybrid_relay", 0) / n
