"""Device ms a batch charged to `engine.tensor` spans: the hmul's tensor
product, ATen's int64 modular passes of core/ops.tensor. Read from the
engine's spans (bench/spans.py); None without them or without an hmul."""
from bench import spans


def read(rec):
    return spans.per_batch_ms(rec, "span_device_s", "engine.tensor")
