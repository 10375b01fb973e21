"""Charge the traced window's device work to the program's own spans.

The engine records a span an op (``engine.op``) and one for each step
inside it (``engine.tensor``, ``engine.keyswitch``, ``engine.rescale``,
...; `repro_torch.compiler.engine`) once a span context is set on it
(`CkksEngine.obs`, an `obs.EngineObs`). Its clock is torch.profiler's
host clock, so the spans and the profiler's events share one timeline. A
device event is charged, through the CUDA runtime call that shares its
correlation id (as bench/devtrace.py charges it to an op range), to the
innermost engine span open at that launch. Events an arrival launched
are charged to none and counted nowhere here; any other event launched
outside every engine span is uncharged.

`SpanRun` is `harness.Run` with its traced window run under a span
context, and its record given `reduce`'s keys; `METRICS` are the
per-layer metrics that read them, each a reader in bench/metrics/. The
benchmark's own traced run (`Run.traced_window`) does not set the
context, so those readers find nothing there and are not entries of
BENCHMARK.json; this module's entry point runs a cell with them:

    python3 -m bench.spans --workload helr-paper.b8 --seed 7 --seconds 10
"""
from __future__ import annotations

import bisect
import contextlib
import sys
from typing import Dict, List, Optional, Tuple

from bench import bound, devtrace, harness

PREFIX = "engine."
KEYSWITCH = "engine.keyswitch"
RESCALE = "engine.rescale"
OUTSIDE = "outside engine spans"

_FHE = "FHE ops (kernels/keyswitch, kernels/modmul, csrc)"
_ENGINE = "engine (compiler/engine)"
METRICS = (
    {"name": "keyswitch_roofline", "unit": "%", "better": "higher",
     "source": "program_span", "layer": _FHE, "moves": "ct_per_s"},
    {"name": "rescale_roofline", "unit": "%", "better": "higher",
     "source": "program_span", "layer": _FHE, "moves": "ct_per_s"},
    {"name": "tensor_product_ms", "unit": "ms", "better": "lower",
     "source": "program_span",
     "layer": "library ops (core/ops, core/modarith)", "moves": "ct_per_s",
     "workloads": ["helr-paper.b8"]},
    {"name": "engine_host_ms", "unit": "ms", "better": "lower",
     "source": "program_span", "layer": _ENGINE, "moves": "ct_per_s"},
    {"name": "const_host_ms", "unit": "ms", "better": "lower",
     "source": "program_span", "layer": _ENGINE, "moves": "ct_per_s"},
    {"name": "const_hit_pct", "unit": "%", "better": "higher",
     "source": "program_counter", "layer": _ENGINE, "moves": "ct_per_s"},
)


def records(events) -> Dict:
    """From a profiler's events (``prof.profiler.kineto_results.events()``):
    each device event as (start, end, launch), launch the start of the
    runtime call that shares its correlation id (None without one), and
    the arrivals' and the batches' ranges, in ns."""
    launch: Dict[int, int] = {}
    arrivals: List[Tuple[int, int]] = []
    batches: List[Tuple[int, int]] = []
    device = []
    for e in events:
        name = e.name()
        if devtrace._is_device(e):
            if not name.startswith("bench."):
                device.append(e)
            continue
        if name == devtrace.ARRIVE:
            arrivals.append((e.start_ns(), e.end_ns()))
        elif name == devtrace.BATCH:
            batches.append((e.start_ns(), e.end_ns()))
        elif devtrace.RUNTIME.match(name):
            launch[e.correlation_id()] = e.start_ns()
    dev = sorted((e.start_ns(), e.end_ns(), launch.get(e.correlation_id()))
                 for e in device)
    return {"device": dev, "arrivals": sorted(arrivals),
            "batches": sorted(batches)}


class _Timeline:
    """The engine's spans on the clock: (start, end, span) sorted by start,
    a parent before a child that starts with it, and the innermost one
    open at a time."""

    def __init__(self, spans, anchor_ns: int):
        self.spans = sorted(
            ((anchor_ns + round(s.start_s * 1e9),
              anchor_ns + round(s.end_s * 1e9), s)
             for s in spans if s.name.startswith(PREFIX)
             and s.end_s is not None),
            key=lambda x: (x[0], -x[1], x[2].span_id))
        self.starts = [s[0] for s in self.spans]
        self.by_id = {s[2].span_id: s for s in self.spans}

    def chain(self, t: int) -> List:
        """The spans open at t, innermost first. Spans nest, so every span
        open at t is the last one started by t or one of its parents."""
        i = bisect.bisect_right(self.starts, t) - 1
        s = self.spans[i] if i >= 0 else None
        while s is not None and s[1] < t:
            s = self.by_id.get(s[2].parent_id)
        out = []
        while s is not None:
            out.append(s[2])
            s = self.by_id.get(s[2].parent_id)
        return out

    def segments(self) -> List[Tuple[int, int, str]]:
        """The host timeline cut where the innermost open span changes:
        (start, end, its name); time outside every span is left out."""
        out, stack, t = [], [], 0
        for s0, s1, sp in self.spans:
            while stack and stack[-1][0] <= s0:
                end, name = stack.pop()
                out.append((t, end, name))
                t = end
            if stack:
                out.append((t, s0, stack[-1][1]))
            stack.append((s1, sp.name))
            t = s0
        while stack:
            end, name = stack.pop()
            out.append((t, end, name))
            t = end
        return [seg for seg in out if seg[1] > seg[0]]


def _in(ranges: List[Tuple[int, int]], t: int) -> bool:
    i = bisect.bisect_right(ranges, (t, float("inf"))) - 1
    return i >= 0 and ranges[i][0] <= t <= ranges[i][1]


def _gaps(dev, segments, w0: int, w1: int) -> Dict[str, float]:
    """Idle seconds of the device by the innermost engine span the host
    was in while the device waited, OUTSIDE where it was in none."""
    idle, last = [], w0
    for start, end, _ in dev:
        if start > last and start <= w1:
            idle.append((last, start))
        last = max(last, end)
    if w1 > last:
        idle.append((last, w1))
    ends = [seg[1] for seg in segments]
    out: Dict[str, float] = {}
    for g0, g1 in idle:
        covered = 0
        i = bisect.bisect_right(ends, g0)
        while i < len(segments) and segments[i][0] < g1:
            s0, s1, name = segments[i]
            d = min(s1, g1) - max(s0, g0)
            if d > 0:
                out[name] = out.get(name, 0.0) + d * 1e-9
                covered += d
            i += 1
        if g1 - g0 > covered:
            out[OUTSIDE] = out.get(OUTSIDE, 0.0) + (g1 - g0 - covered) * 1e-9
    return out


def _bounds(spans, n: int, k: int, alpha: int) -> Dict[str, float]:
    """Op bounds (bench/bound.py) of the keyswitches and the rescales the
    spans record, each at its level and batch: a keyswitch reads one
    polynomial and its key and writes two; a rescale reads a ciphertext
    and writes one a limb shorter."""
    ks = rs = 0.0
    for s in spans:
        if s.name == KEYSWITCH:
            lv, b = s.attrs["level"], s.attrs["batch"]
            ks += bound.seconds(
                b * bound.keyswitch_products(n, lv, k, alpha),
                b * 3 * bound.ct_bytes(n, lv) // 2
                + bound.key_bytes(n, lv, k, alpha))
        elif s.name == RESCALE:
            lv, b = s.attrs["level"], s.attrs["batch"]
            rs += bound.seconds(
                b * bound.rescale_products(n, lv),
                b * (bound.ct_bytes(n, lv) + bound.ct_bytes(n, lv - 1)))
    return {"keyswitch_bound_s": ks, "rescale_bound_s": rs}


def reduce(rec: Dict, spans, anchor_ns: int, n: int, k: int, alpha: int
           ) -> Dict:
    """The record's keys from the engine's spans (`spans`, stamped from
    `anchor_ns`) and `records`' device events: device seconds charged to
    each span name, innermost (``span_device_s``) and counting each span
    around it too (``span_device_incl_s``); host seconds in spans of each
    name, span counts and ``hit`` counts; the keyswitches' and rescales'
    bounds; device seconds launched outside every span and every arrival
    (``span_uncharged_s``); and the idle gaps by span (``span_gaps``)."""
    tl = _Timeline(spans, anchor_ns)
    dev_s: Dict[str, float] = {}
    incl_s: Dict[str, float] = {}
    uncharged = 0.0
    for start, end, launch in rec["device"]:
        d = (end - start) * 1e-9
        chain = tl.chain(launch) if launch is not None else []
        if not chain:
            if launch is None or not _in(rec["arrivals"], launch):
                uncharged += d
            continue
        dev_s[chain[0].name] = dev_s.get(chain[0].name, 0.0) + d
        for s in chain:
            incl_s[s.name] = incl_s.get(s.name, 0.0) + d
    host_s: Dict[str, float] = {}
    count: Dict[str, int] = {}
    hits: Dict[str, int] = {}
    for _, _, s in tl.spans:
        host_s[s.name] = host_s.get(s.name, 0.0) + s.duration_s
        count[s.name] = count.get(s.name, 0) + 1
        if s.attrs.get("hit"):
            hits[s.name] = hits.get(s.name, 0) + 1
    out = {"span_device_s": dev_s, "span_device_incl_s": incl_s,
           "span_host_s": host_s, "span_count": count, "span_hits": hits,
           "span_uncharged_s": uncharged}
    out.update(_bounds((s for _, _, s in tl.spans), n, k, alpha))
    if rec["batches"]:
        out["span_gaps"] = _gaps(rec["device"], tl.segments(),
                                 rec["batches"][0][0], rec["batches"][-1][1])
    return out


# -- the metrics' shared reading ---------------------------------------------

def roofline(rec: Dict, name: str, bound_key: str) -> Optional[float]:
    """Σ bounds ÷ device seconds charged to spans `name`, in %; None
    without spans, or where over 1 % of the device time was launched
    outside every span (as `hmul_roofline` refuses unattributed time)."""
    dev = rec.get("span_device_s", {}).get(name, 0.0)
    b = rec.get(bound_key, 0.0)
    if "span_uncharged_s" not in rec or \
            rec["span_uncharged_s"] > 0.01 * rec.get("device_s", 0.0):
        return None
    return 100.0 * b / dev if dev > 0 and b > 0 else None


def per_batch_ms(rec: Dict, key: str, name: str) -> Optional[float]:
    """rec[key][name] (seconds) over the window's batches, in ms; None
    without spans of that name."""
    v = rec.get(key, {}).get(name)
    if v is None or not rec.get("batches"):
        return None
    return v / rec["batches"] * 1e3


# -- the traced run with the spans armed --------------------------------------

class SpanRun(harness.Run):
    """`harness.Run` whose traced window runs with a span context on the
    engine, set just before the profiled window and taken off after it,
    and whose record holds `reduce`'s keys beside devtrace's."""

    def traced_window(self, seconds: float) -> Dict:
        from repro_torch.obs import EngineObs, Tracer
        obs = EngineObs(Tracer())
        profs = []
        records_of = devtrace.records

        def keep(prof):
            profs.append(prof)
            return records_of(prof)
        self.engine.obs = obs
        devtrace.records = keep
        try:
            red = super().traced_window(seconds)
        finally:
            devtrace.records = records_of
            self.engine.obs = None
        p = self.params
        red.update(reduce(records(profs[0].profiler.kineto_results.events()),
                          obs.tracer.store.spans, obs.anchor_ns, p.n,
                          p.n_special, p.alpha))
        return red


@contextlib.contextmanager
def armed():
    """`harness.execute` runs its cells as `SpanRun`s inside."""
    run_cls = harness.Run
    harness.Run = SpanRun
    try:
        yield
    finally:
        harness.Run = run_cls


def with_metrics(cell: Dict) -> Dict:
    """The cell with `METRICS` that apply to it added to its per-layer
    metrics."""
    extra = [m for m in METRICS if cell["name"] in m.get("workloads",
                                                         [cell["name"]])]
    return {**cell, "per_layer": cell["per_layer"] + extra}


def main(argv=None) -> None:
    """bench/run.py's run of a cell with ``--trace 1``, the spans armed
    and `METRICS` read besides the cell's own."""
    from bench import cells, run
    args = run.parse(list(argv or []) + ["--trace", "1"])
    import torch
    if not torch.cuda.is_available():
        run.fail("no CUDA device")
    from repro_torch.kernels import build
    build.build()
    with armed():
        out = harness.execute(with_metrics(cells.cell(args.workload)),
                              args.seed, args.seconds, True, "cuda",
                              t0=run.T_START)
    found = harness.forbidden_modules(sys.modules)
    if found:
        run.fail("loaded in this process: " + ", ".join(found))
    harness.report(out)


if __name__ == "__main__":
    main(sys.argv[1:])
