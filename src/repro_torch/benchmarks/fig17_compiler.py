"""Fig. 17 counterpart of the port (compiler ablation): per-workload analytic
latency through the load-save pipeline, unoptimized vs per-pass-
cumulative vs the full `repro_torch.compiler` pipeline.

Passes accumulate in the manager's canonical order (dce, fold,
rotation, cse, lazy_rescale), always on top of bootstrap insertion —
the feasibility floor that lets a level-exhausting trace (poly) compile
and run at all instead of dying in `infer_levels`. The delta of each
column over the previous one is that pass's contribution; the last
column over the first is the headline end-to-end win (rotation-heavy
matvec is the showcase: BSGS turns n keyswitches into ~2*sqrt(n)).

The same settings, stages, records and gates as
``benchmarks/fig17_compiler.py``. Analytic: places no tensor.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig17_compiler [--smoke]

Emits ``name,us_per_call,derived`` CSV rows (repro_torch.benchmarks.run
contract) and rewrites ``build/repro_torch/results/fig17_compiler.jsonl``
with one JSON record per (workload, stage) for report.py.
"""
from __future__ import annotations

import argparse
import sys
import time

from repro_torch.benchmarks.common import HOST, row, write_records
from repro_torch.compiler import PASS_ORDER, PassConfig, optimize_trace
from repro_torch.core.params import CkksParams, test_params
from repro_torch.core.pipeline import (MemoryModel,
                                        generate_load_save_pipeline)
from repro_torch.core.trace import LevelBudgetExhausted, trace_program
from repro_torch.runtime.workloads import (HELR_CONSTS, LOLA_CONSTS,
                                           lola_infer, make_helr_iter,
                                           make_matvec, make_poly_eval,
                                           matvec_consts, poly_consts)

# cumulative stages, derived from the manager's canonical pass order so
# the ablation never drifts from the pipeline ("unopt" is bootstrap-only:
# the minimum that makes every workload runnable)
_STAGES = ["unopt"] + [f"+{p.name}" for p in PASS_ORDER
                       if p.name != "bootstrap"]


def _workloads(smoke: bool):
    dim = 16 if smoke else 32
    deg = 12 if smoke else 24
    return {
        "helr": (make_helr_iter(), 2, HELR_CONSTS),
        "lola": (lola_infer, 1, LOLA_CONSTS),
        f"matvec{dim}": (make_matvec(dim), 1, matvec_consts(dim)),
        f"poly{deg}": (make_poly_eval(deg), 1, poly_consts(deg)),
    }


def _setting(smoke: bool):
    if smoke:
        params = test_params(log_n=10, n_levels=8, dnum=2)
        mem = MemoryModel(n_partitions=4, partition_bytes=8 * 2 ** 20)
        return params, mem, 7
    params = CkksParams(log_n=15, log_scale=28, n_levels=15, dnum=3,
                        first_mod_bits=31, scale_mod_bits=28,
                        special_mod_bits=31)
    # partitions sized so a keyswitch stage's evk fits the const budget:
    # the load-save regime (§IV-F) where constants stream once per round
    # and the compiler's rotation-count reduction shows through (with
    # overflowing stages the per-round evk reload masks everything)
    mem = MemoryModel(n_partitions=8, partition_bytes=256 * 2 ** 20,
                      load_bw=64e9, modmul_throughput=8e12,
                      transfer_bw=256e9)
    return params, mem, 12


def main(argv=()) -> list:
    # argv defaults to () so run.py can call main() without
    # this parser swallowing run.py's own flags
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="small params + workloads, fast CI check")
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(list(argv))

    params, mem, start = _setting(args.smoke)
    records = []
    for wname, (fn, n_in, consts) in _workloads(args.smoke).items():
        trace = trace_program(fn, n_in, const_names=consts)
        base_s = None
        report = None
        enabled = ["bootstrap"]
        for stage in _STAGES:
            if stage != "unopt":
                enabled.append(stage[1:])
            cfg = PassConfig(start_level=start).with_passes(tuple(enabled))
            try:
                # verify=True: the static verifier (repro_torch.analysis)
                # sweeps every applied pass plus the final trace; its
                # wall time is the overhead this figure's gate bounds
                opt, report = optimize_trace(trace, params, cfg,
                                             verify=True)
            except LevelBudgetExhausted as e:
                row(f"fig17_{wname}_{stage}", 0.0, f"infeasible: {e}")
                continue
            t0 = time.perf_counter()
            sched = generate_load_save_pipeline(opt, params, mem)
            map_wall = time.perf_counter() - t0
            lat = sched.total_latency(args.batch)
            if base_s is None:
                base_s = lat
            n_rot = sum(1 for o in opt.ops if o.kind == "rotate")
            n_boot = sum(1 for o in opt.ops if o.kind == "bootstrap")
            derived = (f"{len(opt.ops)}ops {n_rot}rot "
                       f"{n_boot}boot speedup={base_s / lat:.2f}x "
                       f"compile={report.wall_s * 1e3:.1f}ms "
                       f"verify={report.verify_wall_s * 1e3:.1f}ms")
            row(f"fig17_{wname}_{stage}", lat * 1e6, derived)
            records.append({
                "workload": wname, "stage": stage,
                "latency_s": lat, "n_ops": len(opt.ops),
                "n_rotations": n_rot, "n_bootstraps": n_boot,
                "speedup_vs_unopt": base_s / lat,
                "compile_wall_s": report.wall_s,
                "map_wall_s": map_wall,
                "verify_wall_s": report.verify_wall_s,
                "verify_findings": report.verify_findings,
                "smoke": bool(args.smoke),
            })
        # per-pass wall/op-delta detail for the full pipeline (the
        # same PassReport the compile cache attaches to schedules and
        # the compile span surfaces per pass); '#'-prefixed so the
        # CSV-row contract of run.py stays parseable
        if report is not None:
            for ln in report.format_table(include_wall=True).splitlines():
                print(f"# {ln}")

    # verification-overhead gate: across the whole run, the static
    # verifier must cost < 5% of compile wall. "Compile" is the full
    # trace->schedule path (passes + mapper), the same window the
    # compile cache's compile span times. Aggregate, not per-record —
    # a 6-op workload's fixed per-sweep cost is a large fraction of a
    # sub-millisecond compile, which says nothing about the verifier's
    # scaling. Full run only: the smoke setting's compiles are so
    # short the ratio is all constant overhead.
    c_wall = sum(r["compile_wall_s"] + r["map_wall_s"] for r in records)
    v_wall = sum(r["verify_wall_s"] for r in records)
    n_find = sum(r["verify_findings"] for r in records)
    row("fig17_verify_overhead", v_wall * 1e6,
        f"verify/compile={v_wall / c_wall * 100:.1f}% "
        f"findings={n_find} records={len(records)}")
    assert n_find == 0, (
        f"verify gate: {n_find} finding(s) on benchmark workloads — "
        f"the compiler emitted an invalid trace")
    if not args.smoke:
        assert v_wall < 0.05 * c_wall, (
            f"verify gate: {v_wall * 1e3:.1f}ms verification vs "
            f"{c_wall * 1e3:.1f}ms compile "
            f"({v_wall / c_wall * 100:.1f}% > 5%)")

    write_records("fig17_compiler.jsonl", records, HOST)
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
