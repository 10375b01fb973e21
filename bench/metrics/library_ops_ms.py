"""Device ms per batch in ATen's kernels (names from at::native) and in
copies and sets: the library ops of core/ops and core/modarith. A kernel
the program adds counts as the program's without an edit here."""


def read(rec):
    if not rec.get("device_events"):
        return None
    return rec["library_s"] / rec["batches"] * 1e3
