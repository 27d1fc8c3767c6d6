"""loop_gap_ms_per_chunk: the device's idle milliseconds in the traced
window over the driver loop's chunks (its progress lines)."""


def read(rec):
    chunks = len(rec.progress())
    if rec.trace is None or chunks == 0:
        return None
    return (rec.window_s - rec.trace["busy_s"]) / chunks * 1e3
