"""Pass manager: runs the pass pipeline with per-pass cost accounting.

`optimize_trace` is the single entry point the runtime uses between
trace capture and the pipeline mapper (`generate_load_save_pipeline`):

    opt, report = optimize_trace(trace, params, PassConfig())
    schedule = generate_load_save_pipeline(opt, params, mem)

Cost accounting sums the same per-op `OpCost` model the mapper bills
stages with, converted to analytic seconds on a reference MemoryModel so
NTT passes, modmuls and byte movement land in one comparable unit. Two
guarantees are enforced per pass:

* never-more-expensive — a pass whose output costs more than its input
  is *reverted* (recorded in the report), and an assertion backstops the
  invariant: no applied optimization pass may increase the OpCost-derived
  analytic seconds. `BootstrapInsertion` is exempt: it adds real work to
  buy feasibility for traces that would otherwise die in `infer_levels`.
* semantic preservation is checked externally by interpreting both
  traces through the real CKKS stack (repro_torch.compiler.interp, exercised
  by tests/test_compiler.py for every pass on every workload).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.core.params import CkksParams
from repro_torch.core.pipeline import MemoryModel
from repro_torch.core.trace import (FheTrace, LevelBudgetExhausted, OpCost,
                              infer_levels, op_cost)
from repro_torch.compiler.ir import clone_ops
from repro_torch.compiler.passes import PASS_ORDER, Pass


@dataclasses.dataclass(frozen=True)
class PassConfig:
    """Which passes run, plus their knobs. Frozen + flat so `key()` can
    participate in the compile cache key (opt and no-opt schedules must
    never collide)."""
    dce: bool = True
    fold: bool = True
    rotation: bool = True
    cse: bool = True
    bootstrap: bool = True
    lazy_rescale: bool = True
    bsgs_min_terms: int = 6
    start_level: Optional[int] = None    # default: read off the trace
    bootstrap_to: Optional[int] = None   # default: start level

    def key(self) -> Tuple:
        return dataclasses.astuple(self)

    def enabled(self) -> List[Pass]:
        return [p for p in PASS_ORDER if getattr(self, p.name)]

    def with_passes(self, names) -> "PassConfig":
        """Copy with exactly `names` enabled (knobs preserved)."""
        flags = {p.name: (p.name in names) for p in PASS_ORDER}
        return dataclasses.replace(self, **flags)

    def resolve_start_level(self, trace: FheTrace,
                            params: CkksParams) -> int:
        if self.start_level is not None:
            return self.start_level
        for i in trace.inputs:
            if trace.ops[i].level is not None:
                return trace.ops[i].level
        return params.n_levels


# reference memory model for pass-to-pass comparisons: any fixed model
# works (comparisons are relative); the default matches fig15's analytic
# baseline so report numbers line up with the benchmarks
_REF_MEM = MemoryModel()


def trace_cost(trace: FheTrace, params: CkksParams) -> OpCost:
    """Summed OpCost over compute ops (levels must be inferred)."""
    total = OpCost()
    for op in trace.compute_ops():
        total = total + op_cost(params, op)
    return total


def analytic_seconds(trace: FheTrace, params: CkksParams,
                     mem: MemoryModel = _REF_MEM) -> float:
    """Single-partition analytic latency: compute + constant streaming +
    ciphertext movement, summed per op. The mapper's pipelining divides
    this across partitions but never changes its ordering between two
    traces, so it is the right pass-comparison scalar."""
    c = trace_cost(trace, params)
    return (mem.compute_seconds(c, params.n)
            + c.const_bytes / mem.load_bw
            + c.io_bytes / mem.transfer_bw)


@dataclasses.dataclass
class PassStats:
    name: str
    n_ops_before: int
    n_ops_after: int
    seconds_before: Optional[float]   # None while levels are infeasible
    seconds_after: Optional[float]
    applied: bool
    reverted: bool = False
    wall_s: float = 0.0               # compile-time cost of the pass
                                      # itself (run + cost re-check)
    verify_wall_s: float = 0.0        # repro_torch.analysis per-pass sweep
    verify_findings: int = 0          # findings (any severity) it raised
    records: List[Dict] = dataclasses.field(default_factory=list)
    #                                   the choices an applied pass
    #                                   reported (its `run_recorded`)

    @property
    def delta_ops(self) -> int:
        return self.n_ops_after - self.n_ops_before

    @property
    def speedup(self) -> Optional[float]:
        if self.seconds_before and self.seconds_after:
            return self.seconds_before / self.seconds_after
        return None


@dataclasses.dataclass
class CompileReport:
    passes: List[PassStats]
    seconds_unopt: Optional[float]
    seconds_opt: float
    n_ops_unopt: int
    n_ops_opt: int
    # static-verification accounting (repro_torch.analysis): per-pass sweeps
    # plus the final full-budget trace verification
    verify_wall_s: float = 0.0
    verify_findings: int = 0

    @property
    def speedup(self) -> Optional[float]:
        if self.seconds_unopt is None:
            return None
        return self.seconds_unopt / self.seconds_opt

    @property
    def wall_s(self) -> float:
        """Total compile wall time across the pass pipeline."""
        return sum(s.wall_s for s in self.passes)

    def format_table(self, include_wall: bool = False) -> str:
        hdr = f"{'pass':<14}{'ops':>10}{'analytic_s':>14}{'Δ':>9}"
        rows = [hdr + (f"{'wall_ms':>10}" if include_wall else "")]
        for s in self.passes:
            sec = "-" if s.seconds_after is None else f"{s.seconds_after:.3e}"
            dlt = ("reverted" if s.reverted
                   else "-" if s.speedup is None
                   else f"{s.speedup:.2f}x")
            row = (f"{s.name:<14}{s.n_ops_before:>5}->{s.n_ops_after:<4}"
                   f"{sec:>13}{dlt:>9}")
            if include_wall:
                row += f"{s.wall_s*1e3:>10.2f}"
            rows.append(row)
        total = "-" if self.speedup is None else f"{self.speedup:.2f}x"
        last = (f"{'total':<14}{self.n_ops_unopt:>5}->"
                f"{self.n_ops_opt:<4}{self.seconds_opt:>13.3e}{total:>9}")
        if include_wall:
            last += f"{self.wall_s*1e3:>10.2f}"
        rows.append(last)
        return "\n".join(rows)


# the name the runtime uses when the report rides a compiled schedule
# (PipelineSchedule.pass_report) and compile spans
PassReport = CompileReport


def _try_seconds(trace, params, start, boot_to):
    try:
        infer_levels(trace, start, boot_to)
        return analytic_seconds(trace, params)
    except LevelBudgetExhausted:
        return None


def optimize_trace(trace: FheTrace, params: CkksParams,
                   config: Optional[PassConfig] = None, *,
                   verify: bool = False,
                   passes: Optional[List[Pass]] = None
                   ) -> Tuple[FheTrace, CompileReport]:
    """Run the enabled passes in canonical order over a private copy.

    Returns (optimized trace with levels inferred, per-pass report).
    Raises LevelBudgetExhausted only if the trace is too deep AND
    bootstrap insertion is disabled (or cannot fix it).

    ``verify=True`` runs the static verifier (repro_torch.analysis) after
    every applied pass — an error finding raises
    `PassVerificationError` naming the offending pass — plus one full
    level-budget verification of the final trace. Per-pass sweeps skip
    the budget rules: a mid-pipeline trace may be legally deeper than
    the chain until bootstrap insertion runs.

    ``passes`` overrides the config's enabled pass list (same Pass
    protocol: .name, .may_increase_cost, .run) — the hook the mutation
    harness uses to inject a corrupting pass without touching
    PASS_ORDER.
    """
    config = config or PassConfig()
    if verify:
        # deferred import: repro_torch.analysis imports core only, but keep
        # the compiler importable without it on the hot path anyway
        from repro_torch.analysis.findings import (PassVerificationError,
                                             VerificationError)
        from repro_torch.analysis.verify_ir import verify_trace
        from repro_torch.analysis.verify_schedule import verify_pass
    start = config.resolve_start_level(trace, params)
    work = FheTrace(clone_ops(trace), list(trace.inputs),
                    list(trace.outputs), list(trace.consts))
    sec_unopt = _try_seconds(work, params, start, config.bootstrap_to)
    n_unopt = len(work.ops)
    sec = sec_unopt
    stats: List[PassStats] = []
    v_wall, v_found = 0.0, 0
    for p in (config.enabled() if passes is None else passes):
        before_ops = len(work.ops)
        t0 = time.perf_counter()
        run_recorded = getattr(p, "run_recorded", None)
        new, records = (run_recorded(work, params, config) if run_recorded
                        else (p.run(work, params, config), []))
        sec_new = _try_seconds(new, params, start, config.bootstrap_to)
        wall = time.perf_counter() - t0
        applied, reverted = True, False
        if not p.may_increase_cost and sec is not None and (
                sec_new is None or sec_new > sec * (1 + 1e-12)):
            new, sec_new = work, sec          # never-more-expensive guard
            applied, reverted = False, True
        if applied and not p.may_increase_cost \
                and sec is not None and sec_new is not None:
            assert sec_new <= sec * (1 + 1e-9), \
                f"pass {p.name} increased analytic cost {sec} -> {sec_new}"
        st = PassStats(p.name, before_ops, len(new.ops),
                       sec, sec_new, applied, reverted, wall_s=wall,
                       records=records if applied else [])
        if verify and applied:
            rep = verify_pass(work, new, check_budget=False,
                              start_level=start,
                              bootstrap_to=config.bootstrap_to,
                              subject=p.name)
            st.verify_wall_s = rep.wall_s
            st.verify_findings = len(rep.findings)
            v_wall += rep.wall_s
            v_found += len(rep.findings)
            if not rep.ok:
                raise PassVerificationError(p.name, rep)
        stats.append(st)
        work, sec = new, sec_new
    if sec is None:
        # still infeasible: surface the structured error to the caller
        infer_levels(work, start, config.bootstrap_to)
    if verify:
        # final sweep WITH the budget rules: every pass has had its say
        rep = verify_trace(work, start_level=start,
                           bootstrap_to=config.bootstrap_to,
                           check_budget=True, subject="post-pipeline")
        v_wall += rep.wall_s
        v_found += len(rep.findings)
        if not rep.ok:
            raise VerificationError(rep, context="optimized trace")
    return work, CompileReport(stats, sec_unopt, sec, n_unopt,
                               len(work.ops), verify_wall_s=v_wall,
                               verify_findings=v_found)


class PassManager:
    """Object wrapper over `optimize_trace` for callers that configure
    once and compile many traces (the lint CLI, tests, notebooks):

        pm = PassManager(PassConfig(), verify=True)
        opt, report = pm.run(trace, params)

    `verify=True` re-verifies the trace after each applied pass and
    attributes the first invariant violation to the offending pass by
    raising `PassVerificationError(pass_name=...)`.
    """

    def __init__(self, config: Optional[PassConfig] = None, *,
                 verify: bool = False,
                 passes: Optional[List[Pass]] = None):
        self.config = config or PassConfig()
        self.verify = verify
        self.passes = passes

    def run(self, trace: FheTrace,
            params: CkksParams) -> Tuple[FheTrace, CompileReport]:
        return optimize_trace(trace, params, self.config,
                              verify=self.verify, passes=self.passes)
