"""Request tracing for the serving stack (the span store and tracer).

Copied from `repro.obs` (span.py, tracer.py). The executor threads
`ExecObs` into its backends; a run without a tracer attached to the
shared `MetricsRegistry` emits nothing. The exporters, telemetry and
analyzers of `repro.obs` are not ported yet.
"""
from repro_torch.obs.span import Span, SpanStore
from repro_torch.obs.tracer import ExecObs, Tracer

__all__ = ["Span", "SpanStore", "ExecObs", "Tracer"]
