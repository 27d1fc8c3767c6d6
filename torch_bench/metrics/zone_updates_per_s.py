"""zone_updates_per_s: every zone-update of the window (each step counts
the zones it had) over the window's wall seconds."""


def read(rec):
    return rec.zone_updates() / rec.window_s if rec.window_s > 0 else None
