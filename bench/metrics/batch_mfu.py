"""The whole batch's share of the card's roofline: the sum of the bounds
(bench/bound.py) of every op of the batches the traced window completed,
over the window's seconds, in %. The FHE counterpart of MFU."""


def read(rec):
    if not rec.get("device_events") or not rec.get("window_s"):
        return None
    return 100.0 * rec["bound_s"] / rec["window_s"]
