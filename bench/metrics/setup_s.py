"""Process start to the first timed batch: imports, CUDA start, the
kernel build (none once built), context and keys, compile, encryption of
the base batches, the queue made from them and the warm batches."""


def read(rec):
    return rec["setup_s"]
