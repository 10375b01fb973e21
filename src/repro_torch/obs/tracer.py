"""`Tracer` — the per-run span emitter the serving stack threads.

Wiring: the tracer hangs off the one `MetricsRegistry` already shared
by every layer (``metrics.tracer``), so queue, batcher, router,
devices, compile cache and backends all reach it without signature
churn. Disabled tracing is the *absence* of a tracer: every emission
site guards with ``tr = metrics.tracer`` / ``if tr is not None`` — one
attribute read and a None test, which is the zero-overhead-when-
disabled contract the bit-for-bit metrics regression pins down.

The tracer never reads a clock of its own. Every emission passes the
caller's current time — the executor's virtual DES ``now`` or the
wall-clock loop time — so spans land exactly inside the scheduler's
timeline (the root ``request`` span's duration IS the request's
recorded latency, to float precision; tested).

Request roots are opened lazily (`ensure_root`): the first layer to
touch a request — router at admission, queue on submit — materializes
its root span, and `close_root` stamps the terminal status
(completed / deadline_miss / dropped_expired / rejected / unfinished).

`ExecObs` is the small context handed down into a backend's
``execute``/``round_seconds`` (tracer, parent span, timeline origin,
device track) so per-round and per-stage spans parent correctly
without the backend knowing about requests at all.
"""
from __future__ import annotations

import itertools
from typing import Dict, NamedTuple, Optional

from repro_torch.obs.span import Span, SpanStore

# requests are duck-typed (runtime.queue.Request) — importing the
# runtime here would cycle: runtime.executor imports obs.tracer for
# ExecObs, and runtime/__init__ eagerly loads executor


class Tracer:
    def __init__(self, store: Optional[SpanStore] = None):
        self.store = store if store is not None else SpanStore()
        self._ids = itertools.count(1)
        self._roots: Dict[int, int] = {}        # request_id -> root span id

    # -- primitive emission --------------------------------------------------

    def begin(self, name: str, t: float, parent: Optional[int] = None,
              track: str = "runtime", request_id: Optional[int] = None,
              **attrs) -> int:
        sid = next(self._ids)
        self.store.add(Span(sid, parent, name, t, None, track,
                            request_id, attrs))
        return sid

    def end(self, span_id: int, t: float, **attrs) -> None:
        s = self.store.get(span_id)
        if s is None:
            return
        s.end_s = t
        if attrs:
            s.attrs.update(attrs)

    def span(self, name: str, start_s: float, end_s: float,
             parent: Optional[int] = None, track: str = "runtime",
             request_id: Optional[int] = None, **attrs) -> int:
        sid = next(self._ids)
        self.store.add(Span(sid, parent, name, start_s, end_s, track,
                            request_id, attrs))
        return sid

    def instant(self, name: str, t: float, parent: Optional[int] = None,
                track: str = "runtime", request_id: Optional[int] = None,
                **attrs) -> int:
        return self.span(name, t, t, parent, track, request_id, **attrs)

    # -- request lifecycle ---------------------------------------------------

    def ensure_root(self, req) -> int:
        """Root ``request`` span on the tenant track, opened at arrival.
        Idempotent — the first touching layer (router or queue) wins."""
        sid = self._roots.get(req.request_id)
        if sid is None:
            sid = self.begin("request", req.arrival_s,
                             track=f"tenant:{req.tenant}",
                             request_id=req.request_id,
                             tenant=req.tenant, workload=req.workload,
                             slots=req.slots_needed,
                             deadline_s=req.deadline_s)
            self._roots[req.request_id] = sid
        return sid

    def root_id(self, request_id: int) -> Optional[int]:
        return self._roots.get(request_id)

    def close_root(self, req, t: float, status: str,
                   **attrs) -> None:
        sid = self._roots.get(req.request_id)
        if sid is None:
            sid = self.ensure_root(req)
        s = self.store.get(sid)
        if s is not None and s.end_s is None:
            self.end(sid, t, status=status, **attrs)

    def close_open(self, t: float) -> None:
        """Finalize: close any span still open (requests left queued
        when the serve window ends, flights cut mid-stream). Stamped
        ``unfinished`` so analyzers and the exporter never see
        half-open intervals."""
        for s in self.store.open_spans():
            s.end_s = max(t, s.start_s)
            s.attrs.setdefault("status", "unfinished")


class ExecObs(NamedTuple):
    """Execution-scope observability context handed into backends.

    ``tracer`` may be None when only telemetry (metrics.telemetry) is
    armed: the backend still needs the timeline origin ``t0`` to stamp
    its series points, so callers construct an ExecObs whenever EITHER
    observer is attached and backends guard span emission on
    ``obs.tracer is not None``."""
    tracer: Optional[Tracer]
    parent: Optional[int]      # the batch/flight span
    t0: float                  # timeline time execution starts
    track: str                 # device track, e.g. "device:0"

    def at(self, t0: float, parent: Optional[int] = None) -> "ExecObs":
        return self._replace(t0=t0,
                             parent=self.parent if parent is None
                             else parent)
