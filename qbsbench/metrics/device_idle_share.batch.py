"""Share of the profiled slice in which no operation ran on the device, in
%: one minus the union of the device's operation intervals over the
slice's wall time."""


def read(raw):
    if not raw.get("window_s") or not raw.get("busy_s"):
        return None
    return 100.0 * (1.0 - raw["busy_s"] / raw["window_s"])
