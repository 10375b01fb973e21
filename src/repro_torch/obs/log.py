"""Structured one-line-JSON event log (``serve_fhe --log-json``).

Machine-readable sibling of `MetricsRegistry.format_table`: one JSON
object per line per request lifecycle event, emitted as the event
happens (timeline order), so a serving run can be tailed, grepped, or
replayed without parsing the human table.

Events and their emitters:

* ``accepted`` / ``rejected``   — admission (queue / executor door)
* ``routed``                    — fleet router placement decision
* ``preempted``                 — flight eviction at a round boundary
* ``completed`` / ``deadline_miss`` — request left the system
* ``dropped``                   — expired at dequeue, never served
* ``slo_alert`` / ``slo_recovered`` — burn-rate monitor transitions
                                  (repro_torch.obs.telemetry.SloBurnRate);
                                  no request in scope

Every record carries ``ts`` (timeline seconds — virtual or wall,
matching the backend's clock), ``event``, and, when a request is in
scope, ``request_id`` / ``tenant`` / ``workload`` / ``deadline_slack_s``
(deadline minus ts; negative = already late; null = best-effort).

Like the tracer, the log hangs off the shared registry
(``metrics.event_log``) and absence means disabled.
"""
from __future__ import annotations

import json
from typing import IO

# requests are duck-typed (runtime.queue.Request) to avoid importing
# the runtime package from obs (see tracer.py)

EVENTS = ("accepted", "rejected", "routed", "preempted", "completed",
          "deadline_miss", "dropped", "slo_alert", "slo_recovered")


class JsonEventLog:
    def __init__(self, stream: IO[str]):
        self.stream = stream
        self.n_events = 0

    def emit(self, event: str, t: float,
             request=None, **fields) -> None:
        rec = {"ts": t, "event": event}
        if request is not None:
            rec["request_id"] = request.request_id
            rec["tenant"] = request.tenant
            rec["workload"] = request.workload
            rec["deadline_slack_s"] = (
                request.deadline_s - t
                if request.deadline_s is not None else None)
        rec.update(fields)
        self.stream.write(json.dumps(rec) + "\n")
        self.n_events += 1
