"""95th percentile of every batch's latency in the window: CUDA events
recorded before the batch's first op is enqueued and after its last, on
an idle device (the previous batch ended in a synchronize)."""
import numpy as np


def read(rec):
    return float(np.percentile(rec["lat_ms"], 95))
