"""Diff two ``build/repro_torch/results/`` runs as a local perf gate: the
port's counterpart of ``benchmarks/compare.py``, with the same specs,
thresholds, arguments and exit codes (0 within budget, 1 on a
regression, 2 when a directory is missing). Pure JSON: places no tensor.

Loads the jsonl artifacts the serving/fleet/telemetry benchmarks write
(fig20 fleet sweep, fig21 trace overhead + critical-path breakdown,
fig22 utilization telemetry) from a BASELINE directory and a CANDIDATE
directory, joins records on their identity fields, and applies a
per-metric regression threshold with the metric's own sign convention
— goodput and utilization may not drop, latency and overhead may not
rise. Exits non-zero when any joined metric regresses past its
threshold, so the workflow

    PYTHONPATH=src python -m repro_torch.benchmarks.run --only fig20
    cp -r build/repro_torch/results build/baseline
    # ... change the code ...
    PYTHONPATH=src python -m repro_torch.benchmarks.run --only fig20
    PYTHONPATH=src python -m repro_torch.benchmarks.compare \\
        build/baseline build/repro_torch/results

is a self-contained perf gate: `git bisect run` can drive it, and CI
can diff a PR's artifacts against the ones cached from the trunk run.
Records present on only one side are reported and skipped (new
figures appear, old ones retire — that is drift, not regression).

DES-clock metrics (fig20/fig22 goodput, latency percentiles,
utilization) are deterministic, so their default thresholds are tight;
wall-clock metrics (fig21/fig22 tracing overhead) carry slack for
runner noise. ``--threshold-scale`` loosens or tightens every
threshold at once (e.g. 2.0 on a noisy laptop).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, NamedTuple, Optional, Tuple


class Spec(NamedTuple):
    """One gated metric: where it lives, how rows join, which way is
    worse, and how much relative movement is tolerated."""
    file: str
    figure: Optional[str]      # record's "figure" field; None = any
    keys: Tuple[str, ...]      # identity fields joining the two runs
    metric: str
    direction: str             # "higher" (drop = regression) | "lower"
    threshold: float           # relative budget, e.g. 0.05 = 5%


SPECS: List[Spec] = [
    # fleet serving (DES, deterministic): goodput floors, latency caps
    Spec("fig20_fleet.jsonl", "sweep", ("devices", "load_mult"),
         "goodput_rps", "higher", 0.02),
    Spec("fig20_fleet.jsonl", "sweep", ("devices", "load_mult"),
         "p99_s", "lower", 0.05),
    Spec("fig20_fleet.jsonl", "ablation", ("router",),
         "goodput_rps", "higher", 0.02),
    # request tracing: per-workload critical-path latency (DES) and
    # the measured wall overhead of armed tracing (noisy)
    Spec("fig21_trace.jsonl", "breakdown", ("workload",),
         "latency_s", "lower", 0.05),
    Spec("fig21_trace.jsonl", "overhead", (),
         "overhead_frac", "lower", 0.50),
    # utilization telemetry: per (workload, preset) goodput and mean
    # bank utilization (DES), plus the armed-observability overhead
    Spec("fig22_utilization.jsonl", "utilization", ("workload", "preset"),
         "goodput_rps", "higher", 0.02),
    Spec("fig22_utilization.jsonl", "utilization", ("workload", "preset"),
         "mean_util", "higher", 0.05),
    Spec("fig22_utilization.jsonl", "overhead", (),
         "overhead_frac", "lower", 0.50),
]


def _load(dirpath: str, fname: str) -> List[dict]:
    path = os.path.join(dirpath, fname)
    if not os.path.exists(path):
        return []
    return [json.loads(line) for line in open(path) if line.strip()]


def _index(recs: List[dict], spec: Spec) -> Dict[Tuple, float]:
    out: Dict[Tuple, float] = {}
    for r in recs:
        if spec.figure is not None and r.get("figure") != spec.figure:
            continue
        if spec.metric not in r:
            continue
        try:
            key = tuple(r[k] for k in spec.keys)
        except KeyError:
            continue
        out[key] = float(r[spec.metric])   # last record wins
    return out


def compare(baseline: str, candidate: str,
            threshold_scale: float = 1.0,
            out=None) -> int:
    """Returns the number of regressions (0 = gate passes)."""
    out = sys.stdout if out is None else out
    n_reg = n_ok = n_skipped = 0
    rows = []
    for spec in SPECS:
        base = _index(_load(baseline, spec.file), spec)
        cand = _index(_load(candidate, spec.file), spec)
        for key in sorted(set(base) | set(cand), key=repr):
            label = (f"{spec.file.split('.')[0]}:{spec.metric}"
                     + (f"[{','.join(map(str, key))}]" if key else ""))
            if key not in base or key not in cand:
                side = "baseline" if key not in cand else "candidate"
                rows.append((label, None, None, None,
                             f"only in {side} — skipped"))
                n_skipped += 1
                continue
            a, b = base[key], cand[key]
            budget = spec.threshold * threshold_scale
            delta = (b - a) / abs(a) if a else (0.0 if b == a
                                               else float("inf"))
            worse = delta < -budget if spec.direction == "higher" \
                else delta > budget
            status = ("REGRESSION" if worse else "ok")
            n_reg += worse
            n_ok += not worse
            rows.append((label, a, b, delta,
                         f"{status} (budget {budget * 100:.0f}%, "
                         f"{spec.direction} is better)"))
    width = max((len(r[0]) for r in rows), default=20)
    for label, a, b, delta, note in rows:
        if a is None:
            print(f"{label:<{width}}  {note}", file=out)
        else:
            print(f"{label:<{width}}  {a:.6g} -> {b:.6g} "
                  f"({delta * 100:+.2f}%)  {note}", file=out)
    print(f"\n{n_ok} metric(s) within budget, {n_reg} regression(s), "
          f"{n_skipped} skipped (one-sided).", file=out)
    return n_reg


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("baseline", help="results dir of the reference run")
    ap.add_argument("candidate", help="results dir of the run under test")
    ap.add_argument("--threshold-scale", type=float, default=1.0,
                    help="multiply every per-metric budget (default 1.0; "
                         "raise on noisy runners, lower to tighten)")
    args = ap.parse_args(argv)
    for d in (args.baseline, args.candidate):
        if not os.path.isdir(d):
            print(f"error: {d!r} is not a directory", file=sys.stderr)
            return 2
    n_reg = compare(args.baseline, args.candidate, args.threshold_scale)
    return 1 if n_reg else 0


if __name__ == "__main__":
    sys.exit(main())
