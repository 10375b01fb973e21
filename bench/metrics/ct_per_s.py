"""Ciphertexts evaluated in the window over the window's seconds (host
clock; the window ends at a batch's synchronize)."""


def read(rec):
    return rec["cts"] / rec["window_s"]
