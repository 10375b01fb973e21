"""Repo lint gate: sweep every registered workload through every pass
configuration and PIM preset, verifying each artifact the compile
produces — trace IR, pipeline schedule, layout and lowered instruction
stream — and exit non-zero on any error finding.

    PYTHONPATH=src python -m repro_torch.analysis.lint --smoke
    PYTHONPATH=src python -m repro_torch.analysis.lint --smoke --prove
    PYTHONPATH=src python -m repro_torch.analysis.lint --jsonl lint.jsonl

``--prove`` additionally runs the mutation harness: every rule in the
catalogue is seeded with a known-bad artifact and must fire with
exactly its own rule id — a verifier rule that cannot fire is itself a
lint failure.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Tuple

from repro_torch.analysis.findings import RULES, Report
from repro_torch.analysis.mutate import (PASS_MUTATIONS, PIM_MUTATIONS,
                                   SCHEDULE_MUTATIONS, TRACE_MUTATIONS,
                                   CorruptingPass, make_clean_artifacts)
from repro_torch.analysis.pim_hazards import analyze_program
from repro_torch.analysis.verify_ir import verify_trace
from repro_torch.analysis.verify_schedule import verify_schedule
from repro_torch.compiler import PassConfig, optimize_trace
from repro_torch.core.params import paper_params_bootstrap, test_params
from repro_torch.core.pipeline import (generate_load_save_pipeline,
                                 generate_naive_pipeline)
from repro_torch.core.trace import trace_program
from repro_torch.pim.arch import PRESETS, get_arch, memory_model
from repro_torch.pim.layout import plan_layout
from repro_torch.pim.lower import lower_schedule


def _workload_table():
    from repro_torch.runtime import workloads as wl
    return {
        "helr": (wl.make_helr_iter(), 2, wl.HELR_CONSTS),
        "lola": (wl.lola_infer, 1, wl.LOLA_CONSTS),
        "matvec": (wl.make_matvec(16), 1, wl.matvec_consts(16)),
        "poly": (wl.make_poly_eval(12), 1, wl.poly_consts(12)),
    }


# pass-config axis: the optimizing default and the verbatim-serving
# no-opt path (bootstrap stays on so deep workloads remain feasible)
def _configs(start_level: int) -> List[Tuple[str, PassConfig]]:
    return [
        ("opt", PassConfig(start_level=start_level)),
        ("noopt", PassConfig(start_level=start_level).with_passes(
            ["bootstrap"])),
    ]


def sweep(params, start_level: int, *, workloads=None, presets=None,
          verbose: bool = False) -> List[Report]:
    """workloads x pass configs x pim presets -> one Report per
    verified artifact."""
    table = _workload_table()
    names = workloads or sorted(table)
    prs = presets or sorted(PRESETS)
    reports: List[Report] = []
    for wname in names:
        fn, n_in, consts = table[wname]
        base = trace_program(fn, n_in, consts)
        for cname, config in _configs(start_level):
            subject = f"{wname}/{cname}"
            opt, _ = optimize_trace(base, params, config, verify=True)
            reports.append(verify_trace(opt, start_level=start_level,
                                        bootstrap_to=config.bootstrap_to,
                                        subject=subject))
            for preset in prs:
                mem = memory_model(preset)
                arch = get_arch(preset)
                for mname, mapper in (
                        ("loadsave", generate_load_save_pipeline),
                        ("naive", generate_naive_pipeline)):
                    subj = f"{subject}/{preset}/{mname}"
                    sched = mapper(opt, params, mem)
                    reports.append(verify_schedule(
                        sched, start_level=start_level,
                        bootstrap_to=config.bootstrap_to,
                        include_trace=False, subject=subj))
                    layout = plan_layout(sched, arch)
                    program = lower_schedule(sched, arch, layout)
                    reports.append(analyze_program(
                        program, sched, arch, layout, subject=subj))
    if verbose:
        for r in reports:
            print(r.format_table())
    return reports


def prove(workload: str = "matvec",
          preset: str = "fhemem") -> List[str]:
    """Seed one known-bad artifact per rule; return the rule ids that
    FAILED to fire (empty list = every rule proven live)."""
    from repro_torch.analysis.findings import PassVerificationError
    art = make_clean_artifacts(workload, preset)
    failed: List[str] = []
    for rule, fn in TRACE_MUTATIONS.items():
        rep = verify_trace(fn(art.trace), start_level=art.start_level)
        if rule not in rep.rule_ids():
            failed.append(rule)
    for rule in PASS_MUTATIONS:
        try:
            optimize_trace(art.trace, art.params,
                           PassConfig(start_level=art.start_level),
                           verify=True, passes=[CorruptingPass(rule)])
            failed.append(rule)
        except PassVerificationError as e:
            if rule not in e.report.rule_ids():
                failed.append(rule)
    for rule, fn in SCHEDULE_MUTATIONS.items():
        rep = verify_schedule(fn(art.schedule),
                              start_level=art.start_level,
                              include_trace=False)
        if rule not in rep.rule_ids():
            failed.append(rule)
    for rule, fn in PIM_MUTATIONS.items():
        prog, layout = fn(art.program, art.schedule, art.layout, art.arch)
        rep = analyze_program(prog, art.schedule, art.arch, layout)
        if rule not in rep.rule_ids():
            failed.append(rule)
    return failed


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--smoke", action="store_true",
                    help="small parameter point (log_n=10, 8 levels)")
    ap.add_argument("--workloads", nargs="*", default=None)
    ap.add_argument("--presets", nargs="*", default=None,
                    choices=sorted(PRESETS))
    ap.add_argument("--jsonl", default=None,
                    help="append one json line per artifact report")
    ap.add_argument("--prove", action="store_true",
                    help="also prove every rule fires on a seeded "
                         "mutation")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    if args.smoke:
        params = test_params(log_n=10, n_levels=8, dnum=2)
        start_level = params.n_levels - 1
    else:
        params = paper_params_bootstrap()
        start_level = params.n_levels - 1

    reports = sweep(params, start_level, workloads=args.workloads,
                    presets=args.presets, verbose=args.verbose)
    n_err = sum(len(r.errors) for r in reports)
    n_warn = sum(len(r.warnings) for r in reports)
    wall = sum(r.wall_s for r in reports)
    print(f"lint: {len(reports)} artifacts, {n_err} errors, "
          f"{n_warn} warnings ({wall * 1e3:.1f} ms verify wall)")
    for r in reports:
        if r.findings:
            print(r.format_table())

    if args.jsonl:
        with open(args.jsonl, "a") as fh:
            for r in reports:
                fh.write(json.dumps(r.to_jsonable()) + "\n")

    rc = 1 if n_err else 0
    if args.prove:
        failed = prove()
        proven = len(RULES) - len(failed)
        print(f"prove: {proven}/{len(RULES)} rules fire on seeded "
              f"mutations")
        if failed:
            print("  rules that did NOT fire: " + ", ".join(failed))
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
