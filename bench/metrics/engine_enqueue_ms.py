"""Host ms a batch, traced window: from the batch's first dispatch to
`run_ops` returning on its last op, before the synchronize; the mean over
the window's batches (their sum spans seconds of host clock). Includes
the profiler's cost of one range an op."""


def read(rec):
    if not rec.get("batches"):
        return None
    return rec["enqueue_s"] / rec["batches"] * 1e3
