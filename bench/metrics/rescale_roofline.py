"""Sum of the rescales' bounds (bench/bound.py at each `engine.rescale`
span's level and batch) over the device time charged to those spans
(K1 and K3 at the rescale's shapes, and the casts), in %. Read from the
engine's spans (bench/spans.py); None without them."""
from bench import spans


def read(rec):
    return spans.roofline(rec, spans.RESCALE, "rescale_bound_s")
