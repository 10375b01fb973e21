"""Chrome/Perfetto ``trace_event`` JSON export of a `SpanStore`.

The emitted object follows the Trace Event Format (the JSON flavor
Perfetto's legacy importer and chrome://tracing both load): a
``traceEvents`` list of complete (``ph:"X"``) events, one per span,
plus ``M`` metadata events naming processes and threads. Tracks map
as:

* ``device:<i>``  -> pid 1 ("devices"),  one tid per device — batch /
                     flight / compile / round / stage spans;
* ``tenant:<t>``  -> pid 2 ("tenants"),  one tid per tenant — request
                     roots with queue_wait / route / service children;
* anything else   -> pid 3 ("runtime");
* telemetry       -> pid 4 ("telemetry"), counter tracks (``ph:"C"``)
                     merged from a `Telemetry` snapshot — one stepped
                     graph per labeled series (bank utilization, queue
                     depth, burn rate ...).

Timestamps are the serving timeline (virtual DES or wall seconds)
converted to microseconds — Perfetto renders either; the clock domain
is recorded in ``otherData.clock``. Span attrs land in ``args`` so a
click shows tenant/workload/status, per-pass compile wall times, and
(pim backend) per-bank ISA cycle-class counts.

``validate(obj)`` is the schema gate CI runs on every emitted trace
(`python -m repro_torch.obs.perfetto validate trace.json`).
"""
from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional

from repro_torch.obs.span import SpanStore

_GROUPS = (("device:", 1, "devices"), ("tenant:", 2, "tenants"))


def _group(track: str):
    for prefix, pid, pname in _GROUPS:
        if track.startswith(prefix):
            return pid, pname, track[len(prefix):]
    return 3, "runtime", track


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return repr(v)


_TELEMETRY_PID = 4


def _counter_events(telemetry) -> List[dict]:
    """Perfetto counter-track (``ph:"C"``) events from a telemetry
    snapshot: one track per labeled series, one event per retained
    point, so utilization / queue depth / burn rate render as stepped
    graphs above the span tracks. Histograms export their observation
    count (the time-resolved part of a histogram series)."""
    events: List[dict] = [
        {"ph": "M", "name": "process_name", "pid": _TELEMETRY_PID,
         "tid": 0, "args": {"name": "telemetry"}}]
    for tid, s in enumerate(telemetry.series(), start=1):
        label = s.name + "".join(f"[{k}={v}]" for k, v in s.labels)
        events.append({"ph": "M", "name": "thread_name",
                       "pid": _TELEMETRY_PID, "tid": tid,
                       "args": {"name": label}})
        for t, v in s.points:
            events.append({"ph": "C", "name": label,
                           "pid": _TELEMETRY_PID, "tid": tid,
                           "ts": t * 1e6, "args": {"value": v}})
    return events


def to_trace_events(store: SpanStore, clock: str = "virtual",
                    telemetry=None) -> dict:
    """Serialize every (closed) span; open spans are exported with zero
    duration and ``status: open`` so a crash dump still loads. With
    ``telemetry`` (repro_torch.obs.Telemetry), its series are merged in as
    counter tracks under a dedicated "telemetry" process."""
    tids: Dict[str, int] = {}
    events: List[dict] = []
    seen_procs = set()
    for track in sorted({s.track for s in store.spans}):
        pid, pname, tname = _group(track)
        tid = tids[track] = len(tids) + 1
        if pid not in seen_procs:
            seen_procs.add(pid)
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0, "args": {"name": pname}})
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": tname}})
    for s in store.spans:
        pid, _, _ = _group(s.track)
        end = s.end_s if s.end_s is not None else s.start_s
        args = {k: _jsonable(v) for k, v in s.attrs.items()}
        args["span_id"] = s.span_id
        if s.parent_id is not None:
            args["parent_span_id"] = s.parent_id
        if s.request_id is not None:
            args["request_id"] = s.request_id
        if s.end_s is None:
            args["status"] = "open"
        events.append({
            "ph": "X", "name": s.name, "cat": s.track.split(":")[0],
            "pid": pid, "tid": tids[s.track],
            "ts": s.start_s * 1e6, "dur": (end - s.start_s) * 1e6,
            "args": args,
        })
    # the reference's generator tag: both packages write the same file
    other = {"generator": "repro.obs", "clock": clock,
             "n_spans": len(store.spans)}
    if telemetry is not None:
        events.extend(_counter_events(telemetry))
        other["n_series"] = len(telemetry)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": other}


def write_trace(store: SpanStore, path: str,
                clock: str = "virtual", telemetry=None) -> dict:
    obj = to_trace_events(store, clock=clock, telemetry=telemetry)
    with open(path, "w") as f:
        json.dump(obj, f)
    return obj


# ---------------------------------------------------------------------------
# schema validation (the CI gate)
# ---------------------------------------------------------------------------

def validate(obj) -> List[str]:
    """Structural check of a trace_event JSON object. Returns a list of
    human-readable problems; empty means valid."""
    errs: List[str] = []
    if not isinstance(obj, dict):
        return [f"top level must be an object, got {type(obj).__name__}"]
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        return ["missing/invalid 'traceEvents' list"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errs.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "M", "i", "B", "E", "C"):
            errs.append(f"{where}: bad ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            errs.append(f"{where}: missing name")
        if not isinstance(ev.get("pid"), int) \
                or not isinstance(ev.get("tid"), int):
            errs.append(f"{where}: pid/tid must be ints")
        if "args" in ev and not isinstance(ev["args"], dict):
            errs.append(f"{where}: args must be an object")
        if ph == "X":
            ts, dur = ev.get("ts"), ev.get("dur")
            if not isinstance(ts, (int, float)):
                errs.append(f"{where}: X event missing numeric ts")
            if not isinstance(dur, (int, float)) or (
                    isinstance(dur, (int, float)) and dur < 0):
                errs.append(f"{where}: X event needs dur >= 0")
        if ph == "C":
            if not isinstance(ev.get("ts"), (int, float)):
                errs.append(f"{where}: C event missing numeric ts")
            args = ev.get("args")
            if not isinstance(args, dict) or not args or not all(
                    isinstance(v, (int, float)) and
                    not isinstance(v, bool) for v in args.values()):
                errs.append(f"{where}: C event args must be a non-empty "
                            f"object of numeric counter values")
        if len(errs) >= 20:
            errs.append("... (truncated)")
            break
    return errs


def validate_file(path: str) -> List[str]:
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"{path}: unreadable trace JSON: {e}"]
    return validate(obj)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 2 or argv[0] != "validate":
        print("usage: python -m repro_torch.obs.perfetto validate TRACE.json",
              file=sys.stderr)
        return 2
    errs = validate_file(argv[1])
    if errs:
        for e in errs:
            print(f"INVALID {e}", file=sys.stderr)
        return 1
    with open(argv[1]) as f:
        n = len(json.load(f).get("traceEvents", []))
    print(f"OK {argv[1]}: {n} events")
    return 0


if __name__ == "__main__":
    sys.exit(main())
