"""Sum of the keyswitches' bounds (bench/bound.py at each `engine.keyswitch`
span's level and batch) over the device time charged to those spans: K1,
K2, K1 on the special limbs, K3 and the casts around them, in %. Read
from the engine's spans (bench/spans.py); None without them."""
from bench import spans


def read(rec):
    return spans.roofline(rec, spans.KEYSWITCH, "keyswitch_bound_s")
