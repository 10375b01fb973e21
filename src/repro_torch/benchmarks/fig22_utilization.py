"""Fig. 22 counterpart of the port (observability): time-series telemetry sweep
over workloads x PIM hardware presets, with in-benchmark gates.

Serves each registered FHE workload (plus one mixed four-workload
stream) through `PipelinedExecutor` on the hierarchical PIM backend at
every hardware preset (flat / fhemem / hbm2, repro_torch.pim.arch), with a
`repro_torch.obs.Telemetry` instance attached to the shared metrics
registry. The DES emits per-bank busy/utilization series (labeled by
dominant ISA phase) and per-scope movement-bandwidth series normalized
against the arch's peak link bandwidth — so presets with wildly
different absolute bandwidths land on one comparable 0..1 axis, the
same normalization trick as the launch roofline's
``roofline_fraction``.

Gates (the fig22 acceptance criteria, enforced in-benchmark):

* **invisibility** — the telemetry-armed run's metrics summary is
  bit-for-bit identical to the detached one on every preset: sampling
  observes the virtual timeline, never perturbs it;
* **fhemem utilization** — every per-bank utilization sample is
  strictly below 1.0 (a stage's busy window can never cover the whole
  round: pipeline fill always adds wall), and the NTT phase is among
  the peak utilization samples — on FHEmem hardware the bit-serial
  NTT is what saturates banks, matching the paper's fig. 22 story;
* **flat == analytic** — the degenerate ``flat`` preset's telemetry
  (per-bank busy seconds) and occupancy utilization reproduce an
  AnalyticBackend serve of the identical arrival stream within 1%:
  the hierarchy model collapses to the flat cost model exactly when
  told to;
* **OpenMetrics round-trip** — the mixed-stream series export
  (``results/fig22_metrics.txt``) parses through the strict
  self-parser with zero errors (``python -m repro_torch.obs.openmetrics
  validate`` works on the artifact);
* **wall overhead** — fig21-style gate on REAL encrypted serving:
  telemetry AND tracer both armed cost < 5% serve wall vs fully
  detached (25% under --smoke, where absolute times are small enough
  for scheduler noise to dominate).

The same settings, seeds, records and gates as
``benchmarks/fig22_utilization.py``, with its fault F8 copied: at the
default size the fhemem gate fails in both packages (the NTT phase's
utilization peaks at 0 while the load phase's peaks at 0.6667); its
``--smoke`` run passes. Only the wall-overhead gate's encrypted serves
(``_overhead``) place tensors, on ``--device`` (cuda, the default, raises
without a CUDA device), through the library keyswitch route
(``use_kernels=False``, the reference's); every other section runs the
PIM or analytic model on a virtual clock.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig22_utilization \
        [--smoke] [--metrics-out PATH] [--device {cuda,cpu}]

Emits ``name,us_per_call,derived`` CSV rows (repro_torch.benchmarks.run
contract) and rewrites
``build/repro_torch/results/fig22_utilization.jsonl`` plus the
OpenMetrics artifact for report.py / CI.
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
from repro_torch.obs import Telemetry, Tracer, parse_openmetrics, write_metrics
from repro_torch.pim.arch import get_arch, memory_model
from repro_torch.pim.lower import program_movement_profile
from repro_torch.runtime import (BatchPolicy, KeyCache, PipelinedExecutor,
                                 Request)
from repro_torch.runtime.metrics import TelemetryHub
from repro_torch.runtime.workloads import (HELR_CONSTS, LOLA_CONSTS,
                                           lola_infer, make_helr_iter,
                                           make_matvec, make_poly_eval,
                                           matvec_consts, poly_consts)

PRESETS = ("flat", "fhemem", "hbm2")


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
        return test_params(log_n=10, n_levels=8, dnum=2), 7, 48
    return test_params(log_n=12, n_levels=10, dnum=2), 9, 320


def _build(smoke: bool, preset: str, backend: str,
           telemetry: bool) -> PipelinedExecutor:
    params, start, _ = _setting(smoke)
    mem = memory_model(preset)
    policy = BatchPolicy(slots_per_ct=params.slots, max_batch=8,
                         max_wait_s=1e-3)
    ex = PipelinedExecutor(
        params, mem, backend=backend, policy=policy,
        key_cache=KeyCache(64 * 2 ** 20, load_bw=mem.load_bw),
        pass_config=PassConfig(start_level=start, bsgs_min_terms=4))
    for name, (fn, n_in, consts) in _workloads(smoke).items():
        ex.register(name, fn, n_in, const_names=consts, start_level=start)
    if telemetry:
        ex.metrics.telemetry = Telemetry(clock="virtual")
    return ex


def _arrivals(ex, n_requests: int, only=None, seed: int = 0,
              rate_rps: float = 4000.0):
    rng = np.random.default_rng(seed)
    names = [only] if only else list(ex.workloads)
    slots = ex.policy.slots_per_ct
    out, t = [], 0.0
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / rate_rps))
        out.append(Request(
            ex.queue.next_request_id(), tenant=f"tenant{i % 3}",
            workload=names[i % len(names)], arrival_s=t,
            slots_needed=int(rng.integers(max(1, slots // 8), slots // 2)),
            deadline_s=t + 0.5))
    return out


def _serve(smoke: bool, preset: str, backend: str, n_req: int,
           only=None, telemetry: bool = True):
    ex = _build(smoke, preset, backend, telemetry)
    ex.warmup()
    m = ex.serve(_arrivals(ex, n_req, only=only))
    return ex, m, ex.metrics.telemetry


def _util_stats(tel):
    """(mean, peak, peak_phase, n_samples, phase peaks) over every
    fhe_pim_bank_utilization sample in the run's ring buffers."""
    vals, peaks = [], {}
    for s in tel.find("fhe_pim_bank_utilization"):
        phase = dict(s.labels)["phase"]
        for _, v in s.points:
            vals.append(v)
            peaks[phase] = max(peaks.get(phase, 0.0), v)
    if not vals:
        return 0.0, 0.0, "none", 0, {}
    peak_phase = max(peaks, key=lambda p: peaks[p])
    return (sum(vals) / len(vals), max(vals), peak_phase, len(vals),
            peaks)


def _overhead(smoke: bool, device):
    """Wall-clock cost of telemetry + tracing BOTH armed on real
    encrypted serving (fig21's interleaved min-of-N protocol, one
    shared CiphertextBackend on `device`, so keys and tables are built
    once)."""
    from repro_torch.runtime import CiphertextBackend
    from repro_torch.core.pipeline import MemoryModel
    params = test_params(log_n=8, n_levels=8, dnum=2, log_scale=26)
    mem = MemoryModel(n_partitions=4, partition_bytes=256 * 2 ** 10)
    backend = CiphertextBackend(params, use_kernels=False, device=device)
    n = 6 if smoke else 40

    def serve_once(armed: bool) -> float:
        ex = PipelinedExecutor(
            params, mem, backend=backend,
            policy=BatchPolicy(slots_per_ct=params.slots, max_batch=2,
                               max_wait_s=1e-3),
            key_cache=KeyCache(64 * 2 ** 20),
            pass_config=PassConfig(start_level=7, bsgs_min_terms=4))
        ex.register("lola", lola_infer, 1, const_names=LOLA_CONSTS,
                    start_level=7)
        if armed:
            ex.metrics.tracer = Tracer()
            ex.metrics.telemetry = Telemetry(clock="wall")
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
    t_off, t_on = float("inf"), float("inf")
    for _ in range(3 if smoke else 5):
        t_off = min(t_off, serve_once(False))
        t_on = min(t_on, serve_once(True))
    return t_off, t_on


def main(argv=()) -> list:
    # argv defaults to () so run.py can call main() without
    # this parser swallowing run.py's own flags
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="small params + short streams, fast CI check")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="OpenMetrics artifact path (default "
                         "results/fig22_metrics.txt)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the encrypted serves of the overhead gate "
                         "run (cuda, the default, raises without a CUDA "
                         "device)")
    args = ap.parse_args(list(argv))
    dev = resolve_device(args.device)
    _, _, n_req = _setting(args.smoke)
    records = []

    # -- sweep: workloads x presets, telemetry-armed PIM serves ----------
    for preset in PRESETS:
        for wname in _workloads(args.smoke):
            ex, m, tel = _serve(args.smoke, preset, "pim",
                                max(12, n_req // 3), only=wname)
            mean_u, peak_u, phase, n_samp, _ = _util_stats(tel)
            hub = TelemetryHub(tel)
            busy = hub.totals("fhe_pim_bank_busy_seconds")
            records.append({
                "figure": "utilization", "workload": wname,
                "preset": preset, "smoke": bool(args.smoke),
                "mean_util": mean_u, "peak_util": peak_u,
                "peak_phase": phase, "n_samples": n_samp,
                "busy_s_total": sum(busy.values()),
                "n_banks_active": len(busy),
                "goodput_rps": m.goodput_rps(),
                "throughput_rps": m.throughput_rps(),
            })
            row(f"fig22_util_{preset}_{wname}", mean_u * 1e6,
                f"mean_util={mean_u * 100:.1f}% "
                f"peak={peak_u * 100:.1f}% ({phase}) "
                f"banks={len(busy)}")

    # -- mixed stream per preset: movement profile + invisibility gate ---
    mixed = {}
    for preset in PRESETS:
        ex_off, m_off, _ = _serve(args.smoke, preset, "pim", n_req,
                                  telemetry=False)
        ex_on, m_on, tel = _serve(args.smoke, preset, "pim", n_req)
        assert m_on.summary() == m_off.summary(), (
            f"telemetry gate [{preset}]: armed metrics summary diverged "
            f"from detached — sampling perturbed the virtual timeline")
        mixed[preset] = (ex_on, m_on, tel)
        progs = [ex_on.backend.program_for(s)
                 for s in ex_on.compile_cache._cache.values()]
        arch = get_arch(preset)
        prof = {}
        for p in progs:
            for e in program_movement_profile(p, arch):
                d = prof.setdefault(e["scope"], dict(e, bytes=0))
                d["bytes"] += e["bytes"]
        bw = {dict(s.labels)["scope"]: max(v for _, v in s.points)
              for s in tel.find("fhe_pim_move_bw_frac")}
        records.append({
            "figure": "movement", "preset": preset,
            "smoke": bool(args.smoke),
            "lowered_bytes": {k: v["bytes"] for k, v in prof.items()},
            "peak_bw_frac": bw,
        })
        top = max(bw, key=lambda s: bw[s]) if bw else "none"
        row(f"fig22_move_{preset}", sum(v["bytes"] for v in prof.values()),
            f"peak link={top} at {bw.get(top, 0) * 100:.1f}% of peak bw")

    # -- gate: fhemem utilization < 1.0 with the NTT phase at the peak ---
    _, _, tel_fm = mixed["fhemem"]
    mean_u, peak_u, phase, n_samp, peaks = _util_stats(tel_fm)
    assert n_samp > 0, "fhemem gate: no utilization samples recorded"
    assert peak_u < 1.0, (
        f"fhemem gate: bank utilization {peak_u} not strictly < 1.0 — "
        f"a stage's busy window covered a whole round (fill vanished?)")
    assert peaks.get("ntt", 0.0) >= peak_u - 1e-12, (
        f"fhemem gate: NTT phase peaks at {peaks.get('ntt', 0.0):.4f} "
        f"but {phase} peaks at {peak_u:.4f} — bit-serial NTT should "
        f"saturate FHEmem banks")
    row("fig22_gate_fhemem", peak_u * 1e6,
        f"peak_util={peak_u * 100:.1f}% (<100%) ntt_peak="
        f"{peaks.get('ntt', 0.0) * 100:.1f}% mean={mean_u * 100:.1f}%")
    records.append({"figure": "gate_fhemem", "smoke": bool(args.smoke),
                    "mean_util": mean_u, "peak_util": peak_u,
                    "phase_peaks": peaks, "n_samples": n_samp})

    # -- gate: flat preset telemetry == analytic backend within 1% -------
    ex_flat, m_flat, tel_flat = mixed["flat"]
    ex_an, m_an, tel_an = _serve(args.smoke, "flat", "analytic", n_req)
    busy_flat = sum(s.value
                    for s in tel_flat.find("fhe_pim_bank_busy_seconds"))
    busy_an = sum(s.value
                  for s in tel_an.find("fhe_partition_busy_seconds"))
    rel = abs(busy_flat - busy_an) / max(busy_an, 1e-30)
    assert rel < 0.01, (
        f"flat gate: pim-degenerate busy {busy_flat} vs analytic "
        f"{busy_an} diverge by {rel * 100:.2f}% (budget 1%)")
    um_flat, _, _ = m_flat.occupancy.active_utilization(m_flat.elapsed_s)
    um_an, _, _ = m_an.occupancy.active_utilization(m_an.elapsed_s)
    urel = abs(um_flat - um_an) / max(um_an, 1e-30)
    assert urel < 0.01, (
        f"flat gate: occupancy utilization {um_flat} vs {um_an} "
        f"diverge by {urel * 100:.2f}% (budget 1%)")
    row("fig22_gate_flat", busy_flat * 1e6,
        f"busy delta={rel * 100:.3f}% util delta={urel * 100:.3f}% "
        f"(budget 1%)")
    records.append({"figure": "gate_flat", "smoke": bool(args.smoke),
                    "busy_pim_s": busy_flat, "busy_analytic_s": busy_an,
                    "busy_rel_err": rel, "util_rel_err": urel})

    # -- gate: OpenMetrics artifact round-trips through the validator ----
    os.makedirs(common.RESULTS, exist_ok=True)
    metrics_path = args.metrics_out or os.path.join(common.RESULTS,
                                                    "fig22_metrics.txt")
    text = write_metrics(metrics_path, tel_fm, mixed["fhemem"][1])
    samples, errors = parse_openmetrics(text)
    assert not errors, f"openmetrics gate: {errors[:3]}"
    row("fig22_gate_openmetrics", float(len(samples)),
        f"{len(samples)} samples, 0 parse errors -> {metrics_path}")
    records.append({"figure": "gate_openmetrics",
                    "smoke": bool(args.smoke),
                    "n_samples": len(samples), "n_series": len(tel_fm),
                    "n_points": tel_fm.n_points(),
                    "path": os.path.basename(metrics_path)})

    # -- gate: wall overhead on real encrypted serving -------------------
    t_off, t_on = _overhead(args.smoke, dev)
    overhead = t_on / t_off - 1.0
    budget = 0.25 if args.smoke else 0.05
    assert overhead < budget, (
        f"overhead gate: telemetry+tracing cost {overhead * 100:.1f}% "
        f"encrypted-serve wall, budget {budget * 100:.0f}% "
        f"({t_on * 1e3:.1f}ms vs {t_off * 1e3:.1f}ms)")
    row("fig22_gate_overhead", t_on * 1e6,
        f"overhead={overhead * 100:+.1f}% (budget {budget * 100:.0f}%) "
        f"detached={t_off * 1e3:.1f}ms")
    records.append({"figure": "overhead", "smoke": bool(args.smoke),
                    "t_detached_s": t_off, "t_armed_s": t_on,
                    "overhead_frac": overhead, "budget_frac": budget})

    write_records("fig22_utilization.jsonl", records, dev)
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
