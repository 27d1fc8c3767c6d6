"""kernels_roofline: the least time the card could take for the window's
work, as the configuration's work model counts it (torch_bench/work), over
the device's busy seconds in the traced window, in percent."""

from torch_bench.work import model


def read(rec):
    if rec.trace is None or rec.trace["busy_s"] <= 0:
        return None
    floor = model.least_seconds(rec.work, rec.zone_updates())
    return None if floor is None else 100.0 * floor / rec.trace["busy_s"]
