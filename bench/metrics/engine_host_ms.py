"""Host ms a batch inside `engine.op` spans: `CkksEngine.run_ops` from an
op's dispatch to its return, summed over the batch's ops; the harness's
loop and the profiler's ranges around the ops are left out. Read from
the engine's spans (bench/spans.py); None without them."""
from bench import spans


def read(rec):
    return spans.per_batch_ms(rec, "span_host_s", "engine.op")
