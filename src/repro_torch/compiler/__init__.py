"""Optimizing FHE trace compiler (paper §IV-F's end-to-end flow).

Sits between trace capture (core/trace.py) and the load-save pipeline
mapper (core/pipeline.py): a pass pipeline over the SSA `FheTrace` IR
with per-pass cost accounting and semantic verification through the
real CKKS stack.

* ``passes``   — DCE, CSE, plaintext constant folding, rotation
                 reuse/BSGS hoisting, lazy rescale placement, automatic
                 bootstrap insertion
* ``manager``  — `PassConfig` + `optimize_trace` with the
                 never-more-expensive guard and `CompileReport`
* ``interp``   — plaintext oracle + real-CKKS trace interpreter
* ``ir``       — rewrite substrate (substitution, pruning, renumbering,
                 derived const expressions)

Entry points: ``optimize_trace(trace, params, PassConfig())``; the
serving runtime reaches it via ``CompileCache.get_schedule(...,
pass_config=...)`` and ``repro_torch.launch.serve_fhe --opt``.
"""
from repro_torch.compiler.manager import (CompileReport, PassConfig, PassManager,
                                    PassReport, PassStats, analytic_seconds,
                                    optimize_trace, trace_cost)
from repro_torch.compiler.passes import (PASS_ORDER, BootstrapInsertion,
                                   CommonSubexpr, ConstantFold,
                                   DeadCodeElimination, LazyRescale,
                                   RotationOpt)
from repro_torch.compiler.interp import CkksTraceInterpreter, reference_eval

__all__ = [
    "CompileReport", "PassConfig", "PassManager", "PassReport", "PassStats",
    "analytic_seconds",
    "optimize_trace", "trace_cost", "PASS_ORDER", "BootstrapInsertion",
    "CommonSubexpr", "ConstantFold", "DeadCodeElimination", "LazyRescale",
    "RotationOpt", "CkksTraceInterpreter", "reference_eval",
]
