"""End-to-end request tracing & profiling for the serving stack.

Span trees from fleet admission down to PIM instruction streams, with
Chrome/Perfetto ``trace_event`` export and an in-process store tests
and the critical-path analyzer query directly.

Enable by attaching a `Tracer` (and optionally a `JsonEventLog`) to
the run's shared `MetricsRegistry`::

    metrics.tracer = Tracer()
    ex.serve(...)
    write_trace(metrics.tracer.store, "trace.json")

Absence of a tracer is the disabled state — every emission site in the
runtime guards on ``metrics.tracer is None``, so a run without one is
bit-for-bit identical to a build without this package (regression-
tested against a metrics golden).

Time-series telemetry (repro_torch.obs.telemetry) rides the same
contract on ``metrics.telemetry``: bounded counter/gauge/histogram series
on the caller's clock, exported as OpenMetrics text
(repro_torch.obs.openmetrics) or Perfetto counter tracks merged into the
trace JSON.

Copied from the reference's ``repro.obs`` with the imports rewritten;
the exports write the same bytes as the reference's on a virtual clock.
"""
from repro_torch.obs.span import Span, SpanStore
from repro_torch.obs.tracer import ExecObs, Tracer
from repro_torch.obs.log import EVENTS, JsonEventLog
from repro_torch.obs.perfetto import (to_trace_events, validate,
                                      validate_file, write_trace)
from repro_torch.obs.critical_path import (Segment, critical_path,
                                           request_chain, workload_breakdown)
from repro_torch.obs.telemetry import (HistogramSeries, Series, SloBurnRate,
                                       Telemetry)
from repro_torch.obs.openmetrics import render as render_openmetrics
from repro_torch.obs.openmetrics import parse as parse_openmetrics
from repro_torch.obs.openmetrics import write_metrics

__all__ = [
    "Span", "SpanStore", "Tracer", "ExecObs", "JsonEventLog", "EVENTS",
    "to_trace_events", "write_trace", "validate", "validate_file",
    "Segment", "critical_path", "request_chain", "workload_breakdown",
    "Telemetry", "Series", "HistogramSeries", "SloBurnRate",
    "render_openmetrics", "parse_openmetrics", "write_metrics",
]
