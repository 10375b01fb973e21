"""Share of the traced window in which no device event ran, in %."""


def read(rec):
    if not rec.get("device_events") or not rec.get("window_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
