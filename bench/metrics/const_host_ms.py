"""Host ms a batch inside `engine.const` spans: each plaintext operand's
expression resolved to slots, its slot vector hashed and the const
cache's lookup (and on a miss its encoding). Read from the engine's
spans (bench/spans.py); None without them."""
from bench import spans


def read(rec):
    return spans.per_batch_ms(rec, "span_host_s", "engine.const")
