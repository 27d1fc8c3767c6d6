"""device_idle_pct: the share of the traced window in which no operation
ran on the card, in percent."""


def read(rec):
    if rec.trace is None or rec.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace["busy_s"] / rec.window_s)
