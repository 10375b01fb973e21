"""Reduce a torch.profiler run of the traced window to the records the
per-layer metrics read.

The traced window runs each op of a batch inside
``record_function("bench.op.<kind>")``, each batch inside
``record_function("bench.batch")`` and each request's arrival (the
client's part: its shift added to a queued ciphertext, enqueued behind
the batch before it) inside ``record_function("bench.arrive")``. Arrival
events count as busy device time and nowhere else. A device event
(kernel, copy or set) is charged to the op whose range holds the host call that launched it:
the CUDA runtime call (cudaLaunchKernel, cuLaunchKernelEx,
cudaMemcpyAsync, ...) that shares the device event's correlation id. The
kernels the program launches through ctypes have no ATen op around
them, so the profiler's link to the innermost torch op does not reach
them; the runtime call does.
"""
from __future__ import annotations

import bisect
import re
from typing import Dict, List, Tuple

OP_PREFIX = "bench.op."
BATCH = "bench.batch"
ARRIVE = "bench.arrive"
ARRIVAL = -1          # the op index of an event an arrival launched
LIBRARY_MARKS = ("at::native",)
COPY_PREFIXES = ("memcpy", "memset")
RUNTIME = re.compile(r"^cu(da)?[A-Z]")


def is_library(name: str) -> bool:
    """ATen's own kernels and the copies: what `core/ops` and
    `core/modarith` launch. Any other device event is the program's."""
    low = name.lower()
    return any(m in name for m in LIBRARY_MARKS) or low.startswith(
        COPY_PREFIXES)


def _is_device(e) -> bool:
    return str(e.device_type()).split(".")[-1] == "CUDA"


def records(prof) -> Dict:
    """The raw records of a finished `torch.profiler.profile`."""
    events = prof.profiler.kineto_results.events()
    ops: List[Tuple[int, int, str]] = []
    batches: List[Tuple[int, int]] = []
    arrivals: List[Tuple[int, int]] = []
    launch: Dict[int, int] = {}
    device = []
    for e in events:
        name = e.name()
        if _is_device(e):
            # the profiler mirrors each host range onto the device's
            # timeline; those are not device work
            if not name.startswith("bench."):
                device.append(e)
            continue
        start, end = e.start_ns(), e.end_ns()
        if name.startswith(OP_PREFIX):
            ops.append((start, end, name[len(OP_PREFIX):]))
        elif name == BATCH:
            batches.append((start, end))
        elif name == ARRIVE:
            arrivals.append((start, end))
        elif RUNTIME.match(name):
            launch[e.correlation_id()] = start
    ops.sort()
    batches.sort()
    arrivals.sort()
    starts = [o[0] for o in ops]
    a_starts = [a[0] for a in arrivals]
    dev = []
    for e in device:
        start, end = e.start_ns(), e.end_ns()
        host = launch.get(e.correlation_id())
        op = None
        if host is not None:
            i = bisect.bisect_right(starts, host) - 1
            if i >= 0 and host <= ops[i][1]:
                op = i
            j = bisect.bisect_right(a_starts, host) - 1
            if op is None and j >= 0 and host <= arrivals[j][1]:
                op = ARRIVAL
        dev.append((start, end, e.name(), op))
    dev.sort()
    return {"ops": ops, "batches": batches, "device": dev}


def reduce(rec: Dict, batch: int, op_bounds: List[Tuple[str, float]]
           ) -> Dict:
    """What the metric readers take: per-batch and per-kind sums over the
    traced window, the window and its busy seconds, and the breakdown.

    `op_bounds` lists (kind, bound seconds) of a batch's compute ops in
    the order they run, so the i-th op range of the window is op
    i mod len(op_bounds)."""
    ops, batches, dev = rec["ops"], rec["batches"], rec["device"]
    n_batches = len(batches)
    if not n_batches:
        return {"batches": 0}
    w0, w1 = batches[0][0], batches[-1][1]
    busy, last = 0, w0
    by_name: Dict[str, float] = {}
    kind_s: Dict[str, float] = {}
    kind_bound: Dict[str, float] = {}
    library_s = unattributed = arrive_s = 0.0
    n_events = 0
    for start, end, name, op in dev:
        s, e = max(start, last), min(end, w1)
        if e > s:
            busy += e - s
            last = e
        d = (end - start) * 1e-9
        if op == ARRIVAL:
            arrive_s += d
            continue
        n_events += 1
        by_name[name] = by_name.get(name, 0.0) + d
        if is_library(name):
            library_s += d
        if op is None:
            unattributed += d
        else:
            kind = ops[op][2]
            kind_s[kind] = kind_s.get(kind, 0.0) + d
    n_ops = len(op_bounds)
    ops_done = n_batches * n_ops
    for kind, b in op_bounds:
        kind_bound[kind] = kind_bound.get(kind, 0.0) + b * n_batches
    # host: from a batch's start to its last op's end, before the sync
    enqueue = 0.0
    for j, (b0, _) in enumerate(batches):
        k = (j + 1) * n_ops - 1
        if k < len(ops):
            enqueue += (ops[k][1] - b0) * 1e-9
    gaps = _idle_gaps(dev, ops, w0, w1, n_ops)
    return {
        "batches": n_batches,
        "batch": batch,
        "ops_traced": len(ops),
        "ops_expected": ops_done,
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": busy * 1e-9,
        "device_events": n_events,
        "device_s": sum(by_name.values()),
        "library_s": library_s,
        "arrive_s": arrive_s,
        "unattributed_s": unattributed,
        "kind_device_s": kind_s,
        "kind_bound_s": kind_bound,
        "bound_s": sum(b for _, b in op_bounds) * n_batches,
        "enqueue_s": enqueue,
        "by_name": by_name,
        "gaps": gaps,
    }


def _idle_gaps(dev, ops, w0: int, w1: int, n_ops: int
               ) -> Dict[str, float]:
    """Idle seconds of the device by what the host was doing: a gap is
    charged to the op that launched the event ending it, or to the batch
    boundary (synchronize, loop) when that event is a batch's first."""
    out: Dict[str, float] = {}
    last = w0
    for start, end, _name, op in dev:
        if start > last and start <= w1:
            if op is None:
                label = "unattributed"
            elif op == ARRIVAL or op % n_ops == 0:
                label = "batch boundary"
            else:
                label = "host in " + ops[op][2]
            out[label] = out.get(label, 0.0) + (start - last) * 1e-9
        last = max(last, end)
    if w1 > last:
        out["batch boundary"] = out.get("batch boundary", 0.0) + \
            (w1 - last) * 1e-9
    return out


def breakdown(red: Dict) -> Dict:
    """The ten device operations that took most time and the ten largest
    idle shares by what the host was doing, in seconds."""
    top = sorted(red.get("by_name", {}).items(), key=lambda kv: -kv[1])
    gaps = sorted(red.get("gaps", {}).items(), key=lambda kv: -kv[1])
    return {"device_ops": [[k[:160], v] for k, v in top[:10]],
            "idle_gaps": [[k, v] for k, v in gaps[:10]]}
