"""Shared reporting structure for the static verification layer.

Every verifier in `repro_torch.analysis` (trace IR, schedule/pass
invariants, PIM hazards) reports through one vocabulary: a `Finding`
names the violated rule, its severity, the locus (op / stage / instr)
and a fix hint; a `Report` collects the findings of one artifact
sweep. The rule catalogue (`RULES`) is the single source of truth for
rule ids and severities — the mutation harness (`repro_torch.analysis
.mutate`) iterates it to prove every rule can fire, and DESIGN.md §14
documents it.

Severity model:

* ``error`` — the artifact violates an invariant the runtime relies
  on; serving it would produce wrong results or crash later. The lint
  CLI exits non-zero and verify-on-miss raises `VerificationError`.
* ``warn``  — legal but suspicious (dead code, cost drift, bank
  imbalance); surfaced, never fatal.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


ERROR = "error"
WARN = "warn"
_RANK = {ERROR: 0, WARN: 1}


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    severity: str
    summary: str


_CATALOGUE = [
    # -- trace IR (repro_torch.analysis.verify_ir) ------------------------
    Rule("T-DEF-USE", ERROR,
         "operand references a later or out-of-range op (SSA def-before-"
         "use; with dense indices this also guarantees acyclicity)"),
    Rule("T-INDEX", ERROR, "op.idx does not match its position"),
    Rule("T-KIND", ERROR, "unknown op kind"),
    Rule("T-ARITY", ERROR, "wrong operand count for the op kind"),
    Rule("T-META", ERROR,
         "required meta key missing (rotate.step, pmul/padd const)"),
    Rule("T-IFACE", ERROR,
         "inputs/outputs/consts interface lists inconsistent with the ops"),
    Rule("T-LEVEL", ERROR,
         "annotated level inconsistent with static inference "
         "(core.trace.infer_levels rules)"),
    Rule("T-BUDGET", ERROR,
         "level budget exhausted: the program is deeper than the modulus "
         "chain (reports the earliest failing op and the latest-legal "
         "bootstrap cut)"),
    Rule("T-SCALE", ERROR,
         "add/sub operands at mismatched scale width (a lazy double-"
         "width partial meets a single-width value)"),
    Rule("T-OVERFLOW", ERROR,
         "scale width leaves [1, 2]: a product chain missed its rescale "
         "(overflow) or rescaled below working scale (underflow)"),
    Rule("T-DEAD", WARN, "compute op unreachable from the outputs"),
    Rule("T-UNUSED-IN", WARN, "declared input is never consumed"),
    # -- schedule (repro_torch.analysis.verify_schedule) ------------------
    Rule("S-COVER", ERROR, "trace compute op not covered by any stage"),
    Rule("S-DUP", ERROR, "op covered by more than one stage slot"),
    Rule("S-ORDER", ERROR,
         "consumer scheduled before its producer across the stage order"),
    Rule("S-ROUND", ERROR,
         "rounds do not partition the stage list in order, or a round "
         "exceeds n_partitions stages"),
    Rule("S-PART", ERROR, "stage partition outside [0, n_partitions)"),
    Rule("S-COST", WARN,
         "stage cost fields diverge from the OpCost recomputation"),
    # -- per-pass semantic diff (repro_torch.analysis.verify_schedule) ----
    Rule("P-IFACE", ERROR,
         "pass changed the trace interface (input/output arity or input "
         "slot bindings)"),
    Rule("P-CONST", ERROR,
         "pass introduced a constant expression over an unknown base "
         "constant"),
    # -- PIM instruction stream (repro_torch.analysis.pim_hazards) --------
    Rule("M-OPCODE", ERROR,
         "unknown opcode, out-of-range stage, or negative cycle/byte/row "
         "count"),
    Rule("M-ORDER", ERROR,
         "RAW hazard: a consumer's instructions issue before its "
         "producer's within the stage stream"),
    Rule("M-LOAD-ORDER", ERROR,
         "instruction issues before the stage's constant LOAD (operating "
         "on rows whose constants are still in flight)"),
    Rule("M-STORE-ORDER", ERROR,
         "WAR hazard: work issues after the stage's STORE shipped the "
         "output rows"),
    Rule("M-ORPHAN", ERROR,
         "orphaned or missing LOAD/STORE relative to the stage's "
         "const/output bytes"),
    Rule("M-PLACE", ERROR,
         "exactly-once limb placement violated (a limb row placed never "
         "or more than once)"),
    Rule("M-CAP", ERROR,
         "subarray over capacity within one (round, generation)"),
    Rule("M-BAL", WARN,
         "per-bank utilization imbalance inside one pipeline round"),
]

RULES: Dict[str, Rule] = {r.id: r for r in _CATALOGUE}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    severity: str
    locus: str                       # "op 12 (hmul)" | "stage 3" | "instr 7"
    message: str
    hint: str = ""
    op_idx: Optional[int] = None
    stage: Optional[int] = None
    instr: Optional[int] = None

    def format(self) -> str:
        s = f"{self.severity:<5} {self.rule:<13} @ {self.locus}: {self.message}"
        if self.hint:
            s += f"  [hint: {self.hint}]"
        return s

    def to_jsonable(self) -> dict:
        d = {"rule": self.rule, "severity": self.severity,
             "locus": self.locus, "message": self.message}
        if self.hint:
            d["hint"] = self.hint
        for k in ("op_idx", "stage", "instr"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        return d


@dataclasses.dataclass
class Report:
    """Findings of one verifier run over one artifact."""
    artifact: str                    # trace | schedule | pass | pim
    subject: str = ""                # workload / pass name / preset
    findings: List[Finding] = dataclasses.field(default_factory=list)
    wall_s: float = 0.0

    def add(self, rule: str, locus: str, message: str, hint: str = "",
            **locus_ids) -> Finding:
        f = Finding(rule, RULES[rule].severity, locus, message, hint,
                    **locus_ids)
        self.findings.append(f)
        return f

    def extend(self, other: "Report") -> None:
        self.findings.extend(other.findings)
        self.wall_s += other.wall_s

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == ERROR]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == WARN]

    @property
    def ok(self) -> bool:
        return not self.errors

    def rule_ids(self) -> List[str]:
        return sorted({f.rule for f in self.findings})

    def format_table(self) -> str:
        head = (f"{self.artifact}" +
                (f" [{self.subject}]" if self.subject else "") +
                f": {len(self.errors)} errors, "
                f"{len(self.warnings)} warnings")
        lines = [head]
        for f in sorted(self.findings, key=lambda f: _RANK[f.severity]):
            lines.append("  " + f.format())
        return "\n".join(lines)

    def to_jsonable(self) -> dict:
        return {"artifact": self.artifact, "subject": self.subject,
                "n_errors": len(self.errors),
                "n_warnings": len(self.warnings),
                "wall_s": round(self.wall_s, 6),
                "findings": [f.to_jsonable() for f in self.findings]}


class VerificationError(Exception):
    """An error-severity finding in a verify-on-miss / --verify flow.
    Carries the report so callers can render or persist it."""

    def __init__(self, report: Report, context: str = ""):
        self.report = report
        self.context = context
        first = report.errors[0] if report.errors else None
        msg = (f"{context + ': ' if context else ''}"
               f"{len(report.errors)} error finding(s) in "
               f"{report.artifact}"
               f"{' [' + report.subject + ']' if report.subject else ''}")
        if first is not None:
            msg += f"; first: {first.format()}"
        super().__init__(msg)


class PassVerificationError(VerificationError):
    """`PassManager(verify=True)` caught a pass breaking an invariant;
    `pass_name` attributes the first violation to the pass that
    introduced it."""

    def __init__(self, pass_name: str, report: Report):
        self.pass_name = pass_name
        super().__init__(report, context=f"pass {pass_name!r}")
