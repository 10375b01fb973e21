"""Fig. 21 counterpart of the port (observability): tracing overhead gate and
per-workload critical-path breakdown on the serving stack.

Drives the fig16-style serving scenario (mixed four-workload Poisson
stream through `PipelinedExecutor` on the analytic backend) twice on
identical arrival schedules — tracer detached vs `Tracer` attached —
and enforces the tentpole's acceptance criteria in-benchmark:

* **throughput gate** — the traced run's metrics summary (throughput,
  latency percentiles, every counter) is bit-for-bit identical to the
  untraced one: spans observe the virtual timeline, never perturb it,
  so tracing costs exactly 0% of reported serving throughput;
* **wall-clock gate** — on the backend that does real work per batch
  (`CiphertextBackend`, real encrypted execution on a wall clock),
  attached tracing costs < 5% serve wall time (min-of-3 timings; the
  smoke setting relaxes to 25% because its absolute times are small
  enough for scheduler noise to dominate). The analytic run's wall
  overhead is also reported, informationally: there the "backend" is
  a cost-model evaluation taking microseconds per round, so span
  emission is a visible fraction of the *simulator harness* — that
  number is the cost of tracing a simulation, not of tracing serving;
* **completeness gate** — every completed request yields a span tree
  whose root ``request`` span duration IS the recorded latency: the
  count and mean of root durations match the latency accumulator to
  float precision.

The traced run then feeds `repro_torch.obs.critical_path.workload_breakdown`
— where each workload's latency actually goes (queue wait vs constant
load vs compute vs on-chip movement) — which report.py renders as the
fig21 table, and the trace itself is exported to
``build/repro_torch/results/fig21_trace.json`` so CI can schema-validate
a real artifact (``python -m repro_torch.obs.perfetto validate``).

A final PIM section re-runs one traced batch on the hierarchical
backend and rolls stage spans' ``isa_cycles`` up to per-class totals —
the span-tree-to-instruction-stream attribution the tentpole promises.

The same settings, seeds, records and gates as
``benchmarks/fig21_trace.py``. Only the wall-clock gate's encrypted
serves (``_ct_overhead``) place tensors, on ``--device`` (cuda, the
default, raises without a CUDA device), through the library keyswitch
route (``use_kernels=False``, the reference's); every other section runs
the analytic or PIM model on a virtual clock.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig21_trace [--smoke] \
        [--trace-out PATH] [--device {cuda,cpu}]

Emits ``name,us_per_call,derived`` CSV rows (repro_torch.benchmarks.run
contract) and rewrites ``build/repro_torch/results/fig21_trace.jsonl``
for report.py.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from repro_torch.benchmarks import common
from repro_torch.benchmarks.common import row, write_records
from repro_torch.compiler import PassConfig
from repro_torch.core.context import resolve_device
from repro_torch.core.params import test_params
from repro_torch.core.pipeline import MemoryModel
from repro_torch.obs import Tracer, workload_breakdown, write_trace
from repro_torch.runtime import (BatchPolicy, KeyCache, PipelinedExecutor,
                                 Request)
from repro_torch.runtime.workloads import (HELR_CONSTS, LOLA_CONSTS,
                                           lola_infer, make_helr_iter,
                                           make_matvec, make_poly_eval,
                                           matvec_consts, poly_consts)



def _workloads(smoke: bool):
    dim = 8 if smoke else 16
    deg = 6 if smoke else 8
    rots = (1, 2, 4) if smoke else (1, 2, 4, 8, 16, 32)
    return {
        "helr": (make_helr_iter(rots), 2, HELR_CONSTS),
        "lola": (lola_infer, 1, LOLA_CONSTS),
        "matvec": (make_matvec(dim), 1, matvec_consts(dim)),
        "poly": (make_poly_eval(deg), 1, poly_consts(deg)),
    }


def _setting(smoke: bool):
    if smoke:
        params = test_params(log_n=10, n_levels=8, dnum=2)
        mem = MemoryModel(n_partitions=4, partition_bytes=8 * 2 ** 20)
        return params, mem, 7, 120
    params = test_params(log_n=12, n_levels=10, dnum=2)
    mem = MemoryModel(n_partitions=8, partition_bytes=32 * 2 ** 20)
    return params, mem, 9, 2000


def _build(smoke: bool, traced: bool, backend: str = "analytic"):
    params, mem, start, _ = _setting(smoke)
    policy = BatchPolicy(slots_per_ct=params.slots, max_batch=8,
                         max_wait_s=1e-3)
    ex = PipelinedExecutor(
        params, mem, backend=backend, policy=policy,
        pass_config=PassConfig(start_level=start, bsgs_min_terms=4))
    for name, (fn, n_in, consts) in _workloads(smoke).items():
        ex.register(name, fn, n_in, const_names=consts, start_level=start)
        # prewarm the compile cache so the timed serves measure
        # steady-state serving, not the one-time mapper cost
        ex.compile_cache.get_schedule(ex.workloads[name].trace, params,
                                      mem, pass_config=ex.pass_config)
    working_set = max(
        sum(st.const_bytes for st in ex.compile_cache.get_schedule(
            w.trace, params, mem, pass_config=ex.pass_config).stages)
        for w in ex.workloads.values())
    ex.key_cache = KeyCache(2 * working_set, load_bw=mem.load_bw,
                            metrics=ex.metrics)
    if traced:
        ex.metrics.tracer = Tracer()
    return ex


def _arrivals(ex, n_requests: int, rate_rps: float, seed: int = 0):
    rng = np.random.default_rng(seed)
    names = list(ex.workloads)
    slots = ex.policy.slots_per_ct
    out, t = [], 0.0
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / rate_rps))
        out.append(Request(
            ex.queue.next_request_id(), tenant=f"tenant{i % 4}",
            workload=names[int(rng.integers(len(names)))], arrival_s=t,
            slots_needed=int(rng.integers(slots // 8, slots // 2))))
    return out


def _timed_serve(smoke: bool, traced: bool, n_req: int, rate: float):
    """Fresh executor + identical arrival stream; returns
    (min serve wall seconds of 3, last metrics, last executor)."""
    best, m, ex = float("inf"), None, None
    for _ in range(3):
        ex = _build(smoke, traced)
        arrivals = _arrivals(ex, n_req, rate)
        t0 = time.perf_counter()
        m = ex.serve(arrivals)
        best = min(best, time.perf_counter() - t0)
    return best, m, ex


def _ct_overhead(smoke: bool, device):
    """Wall-clock tracing overhead on real encrypted execution: one
    shared `CiphertextBackend` on `device` (keys and tables built once
    for all reps), fresh executor + identical lola arrival stream per
    rep, min-of-3 serve timings traced vs untraced."""
    from repro_torch.runtime import CiphertextBackend
    params = test_params(log_n=8, n_levels=8, dnum=2, log_scale=26)
    mem = MemoryModel(n_partitions=4, partition_bytes=256 * 2 ** 10)
    backend = CiphertextBackend(params, use_kernels=False, device=device)
    n = 6 if smoke else 40

    def serve_once(traced: bool) -> float:
        ex = PipelinedExecutor(
            params, mem, backend=backend,
            policy=BatchPolicy(slots_per_ct=params.slots, max_batch=2,
                               max_wait_s=1e-3),
            key_cache=KeyCache(64 * 2 ** 20),
            pass_config=PassConfig(start_level=7, bsgs_min_terms=4))
        ex.register("lola", lola_infer, 1, const_names=LOLA_CONSTS,
                    start_level=7)
        if traced:
            ex.metrics.tracer = Tracer()
        rng = np.random.default_rng(3)
        arrivals = [Request(ex.queue.next_request_id(), f"t{i % 2}",
                            "lola", arrival_s=i * 1e-4, slots_needed=8,
                            payload=rng.uniform(-0.8, 0.8, size=8))
                    for i in range(n)]
        ex.warmup()
        t0 = time.perf_counter()
        ex.serve(arrivals)
        return time.perf_counter() - t0

    serve_once(False)                       # warm-up, untimed
    # interleave modes so clock drift (thermal, background load) hits
    # both sides equally; min-of-N is the noise floor estimator
    t_off, t_on = float("inf"), float("inf")
    for _ in range(3 if smoke else 5):
        t_off = min(t_off, serve_once(False))
        t_on = min(t_on, serve_once(True))
    return t_off, t_on


def _verify_compile_spans(smoke: bool, rate: float):
    """One traced serve on a ``verify=True`` executor with a cold
    compile cache: every workload's first batch misses, so its
    ``compile`` span carries the verify-on-miss wall time and finding
    count the compile cache stamped on it. Returns the per-span
    aggregation report.py renders as the fig21 verify line."""
    params, mem, start, _ = _setting(smoke)
    policy = BatchPolicy(slots_per_ct=params.slots, max_batch=8,
                         max_wait_s=1e-3)
    ex = PipelinedExecutor(
        params, mem, backend="analytic", policy=policy,
        pass_config=PassConfig(start_level=start, bsgs_min_terms=4),
        verify=True)
    ex.metrics.tracer = Tracer()            # attached BEFORE any compile
    for name, (fn, n_in, consts) in _workloads(smoke).items():
        ex.register(name, fn, n_in, const_names=consts, start_level=start)
    ex.serve(_arrivals(ex, 24, rate))
    misses = [s for s in ex.metrics.tracer.store.by_name("compile")
              if not s.attrs.get("hit")]
    assert misses, "verify section: no compile-miss spans recorded"
    c_wall = sum(s.attrs["wall_s"] for s in misses)
    v_wall = sum(s.attrs["verify_wall_s"] for s in misses)
    findings = sum(s.attrs["verify_findings"] for s in misses)
    assert v_wall > 0, "verify section: spans carry no verify wall"
    assert findings == 0, (
        f"verify section: {findings} finding(s) on benchmark workloads")
    return {"n_compiles": len(misses), "compile_wall_s": c_wall,
            "verify_wall_s": v_wall, "verify_findings": findings,
            "verify_frac": v_wall / c_wall}


def _pim_isa_rollup(smoke: bool, n_req: int, rate: float):
    """One traced serve on the hierarchical PIM backend; roll stage
    spans' per-instruction-class cycle attribution up to totals."""
    ex = _build(smoke, traced=True, backend="pim")
    m = ex.serve(_arrivals(ex, max(8, n_req // 10), rate))
    totals = {}
    for s in ex.metrics.tracer.store.by_name("stage"):
        for k, v in s.attrs.get("isa_cycles", {}).items():
            totals[k] = totals.get(k, 0.0) + v
    return m, dict(sorted(totals.items(), key=lambda kv: -kv[1]))


def main(argv=()) -> list:
    # argv defaults to () so run.py can call main() without
    # this parser swallowing run.py's own flags
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="small params + short stream, fast CI check")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="trace JSON path (default results/fig21_trace"
                         ".json)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the encrypted serves of the wall-clock "
                         "gate run (cuda, the default, raises without a "
                         "CUDA device)")
    args = ap.parse_args(list(argv))
    dev = resolve_device(args.device)

    params, mem, start, n_req = _setting(args.smoke)
    # offered near single-device capacity so queues form and the
    # breakdown has a queue_wait story to tell
    probe = _build(args.smoke, traced=False)
    pm = probe.serve(_arrivals(probe, max(40, n_req // 8), 1e9))
    rate = 0.9 * pm.count("requests_completed") / pm.elapsed_s

    t_off, m_off, _ = _timed_serve(args.smoke, False, n_req, rate)
    t_on, m_on, ex = _timed_serve(args.smoke, True, n_req, rate)
    sim_overhead = t_on / t_off - 1.0
    budget = 0.25 if args.smoke else 0.05

    # gate 1: identical metrics — tracing observes, never perturbs, so
    # the reported serving throughput is bit-for-bit unchanged (0%)
    assert m_on.summary() == m_off.summary(), (
        "tracing gate: traced metrics summary diverged from untraced")
    assert m_on.throughput_rps() == m_off.throughput_rps()

    # gate 2: wall-clock overhead on REAL execution within budget
    ct_off, ct_on = _ct_overhead(args.smoke, dev)
    ct_overhead = ct_on / ct_off - 1.0
    assert ct_overhead < budget, (
        f"tracing gate: {ct_overhead * 100:.1f}% encrypted-serve wall "
        f"overhead exceeds {budget * 100:.0f}% "
        f"({ct_on * 1e3:.1f}ms vs {ct_off * 1e3:.1f}ms)")
    # simulator-harness cost (informational — the analytic "backend"
    # is microseconds of arithmetic per round, so span emission shows;
    # guard only against pathological emission-path regressions)
    assert sim_overhead < 1.5, (
        f"tracing gate: {sim_overhead * 100:.0f}% simulator harness "
        f"overhead — span emission path regressed")

    store = ex.metrics.tracer.store
    # gate 3: complete span trees — root duration IS recorded latency
    roots = [s for s in store.by_name("request")
             if s.attrs.get("status") in ("completed", "deadline_miss")]
    lat = m_on.request_latency
    assert len(roots) == lat.count, (
        f"completeness gate: {len(roots)} closed request roots vs "
        f"{lat.count} recorded latencies")
    mean_root = sum(s.duration_s for s in roots) / len(roots)
    assert abs(mean_root - lat.mean) <= 1e-9 * max(lat.mean, 1e-30), (
        f"completeness gate: mean root span duration {mean_root!r} != "
        f"recorded mean latency {lat.mean!r}")

    row("fig21_overhead_encrypted", ct_on * 1e6,
        f"overhead={ct_overhead * 100:+.1f}% (budget {budget * 100:.0f}%) "
        f"untraced={ct_off * 1e3:.1f}ms")
    row("fig21_overhead_simulator", t_on * 1e6,
        f"overhead={sim_overhead * 100:+.1f}% (harness, informational) "
        f"untraced={t_off * 1e3:.1f}ms spans={len(store)} "
        f"throughput_delta=0%")

    records = [{
        "figure": "overhead", "smoke": bool(args.smoke),
        "t_untraced_s": ct_off, "t_traced_s": ct_on,
        "overhead_frac": ct_overhead, "budget_frac": budget,
        "sim_t_untraced_s": t_off, "sim_t_traced_s": t_on,
        "sim_overhead_frac": sim_overhead,
        "n_spans": len(store), "n_requests": lat.count,
    }]
    for wname, bd in sorted(workload_breakdown(store).items()):
        records.append(dict(bd, figure="breakdown", workload=wname,
                            smoke=bool(args.smoke)))
        row(f"fig21_breakdown_{wname}", bd["latency_s"] * 1e6,
            f"n={bd['n']} queue={bd['queue_s'] * 1e6:.1f}us "
            f"load={bd['load_s'] * 1e6:.1f}us "
            f"compute={bd['compute_s'] * 1e6:.1f}us "
            f"move={bd['move_s'] * 1e6:.1f}us")

    pim_m, isa = _pim_isa_rollup(args.smoke, n_req, rate)
    top = " ".join(f"{k}={v:.0f}" for k, v in list(isa.items())[:4])
    row("fig21_pim_isa", sum(isa.values()), f"cycles by class: {top}")
    records.append({"figure": "pim_isa", "smoke": bool(args.smoke),
                    "class_cycles": isa,
                    "n_requests": pim_m.count("requests_completed")})

    # static-verification overhead as the compile spans report it
    # (fig17 owns the <5%-of-compile-wall gate on the full setting;
    # this line shows the same overhead on the serving path)
    ver = _verify_compile_spans(args.smoke, rate)
    row("fig21_verify", ver["verify_wall_s"] * 1e6,
        f"verify/compile={ver['verify_frac'] * 100:.1f}% "
        f"findings={ver['verify_findings']} "
        f"compiles={ver['n_compiles']}")
    records.append(dict(ver, figure="verify", smoke=bool(args.smoke)))

    os.makedirs(common.RESULTS, exist_ok=True)
    trace_path = args.trace_out or os.path.join(common.RESULTS,
                                                "fig21_trace.json")
    write_trace(store, trace_path, clock="virtual")
    write_records("fig21_trace.jsonl", records, dev)
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
