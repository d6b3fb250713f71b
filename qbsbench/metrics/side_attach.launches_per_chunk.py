"""``side_attach`` launches (``kernels.ops.LAUNCHES``: the certificate, each
closure step and the edge pass, per side) over the window per general chunk
dispatched.  None from a program without the kernel (no such counter)."""


def read(raw):
    n = raw.get("general_chunks")
    launches = raw.get("launches")
    if not n or launches is None or "side_attach" not in launches:
        return None
    return launches["side_attach"] / n
