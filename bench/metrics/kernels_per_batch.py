"""Device kernels, copies and sets launched per batch (profiler)."""


def read(rec):
    if not rec.get("device_events"):
        return None
    return rec["device_events"] / rec["batches"]
