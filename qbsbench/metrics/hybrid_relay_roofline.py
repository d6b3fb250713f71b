"""The fused relay's share of its roofline in the profiled slice, in %: the
least time its calls could take (the bytes each call needs,
``peaks.hybrid_relay_bytes``, at the HBM's published rate) over the device
time of its two kernels (``pack_kernel``, ``pull_kernel``) in the trace."""
from qbsbench.peaks import HBM_BYTES_PER_S

KERNELS = ("pack_kernel", "pull_kernel")


def read(raw):
    dev = raw.get("kernel_device_s") or {}
    t = sum(dev.get(k, 0.0) for k in KERNELS)
    b = raw.get("relay_bytes", 0)
    if t <= 0 or b <= 0:
        return None
    return 100.0 * b / HBM_BYTES_PER_S / t
