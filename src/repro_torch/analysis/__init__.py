"""Static verification layer: trace/schedule verifiers and the PIM
hazard analyzer (DESIGN.md §14).

Everything here runs WITHOUT ciphertext math — pure walks over the
artifacts the compile pipeline already produces:

* ``verify_trace``     — SSA/interface structure, level-budget and
                         scale-width inference, liveness lints
* ``verify_schedule``  — stage coverage, cross-stage topological
                         order, round/partition shape, cost recheck
* ``verify_pass``      — per-pass semantic diff (interface + constant
                         provenance), used by
                         ``optimize_trace(..., verify=True)``
* ``analyze_program``  — RAW/WAR hazards, orphaned LOAD/STOREs,
                         placement/capacity invariants, bank balance

Reporting is shared (`Finding`/`Report`, catalogue in `RULES`);
`VerificationError` carries a report across the verify-on-miss and
``--verify`` flows. The mutation harness (`repro_torch.analysis.mutate`)
and lint gate (`python -m repro_torch.analysis.lint`) are leaf modules —
import them directly.
"""
from repro_torch.analysis.findings import (ERROR, RULES, WARN, Finding,
                                     PassVerificationError, Report, Rule,
                                     VerificationError)
from repro_torch.analysis.pim_hazards import analyze_program
from repro_torch.analysis.verify_ir import verify_trace
from repro_torch.analysis.verify_schedule import verify_pass, verify_schedule

__all__ = [
    "ERROR", "WARN", "RULES", "Rule", "Finding", "Report",
    "VerificationError", "PassVerificationError",
    "verify_trace", "verify_schedule", "verify_pass", "analyze_program",
]
