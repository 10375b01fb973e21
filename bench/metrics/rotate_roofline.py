"""Sum of the rotate ops' bounds (bench/bound.py) over the device time of
the kernels charged to rotate ops, in %."""


def read(rec):
    if rec.get("unattributed_s", 0.0) > 0.01 * rec.get("device_s", 0.0):
        return None      # device time that no op's range launched
    dev = rec.get("kind_device_s", {}).get("rotate", 0.0)
    b = rec.get("kind_bound_s", {}).get("rotate", 0.0)
    return 100.0 * b / dev if dev > 0 and b > 0 else None
