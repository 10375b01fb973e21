"""Static verifier for `PipelineSchedule`s and per-pass semantic diffs.

Schedule rules: every trace compute op covered exactly once across the
stages (S-COVER/S-DUP), dataflow topological order respected across
stage boundaries (S-ORDER — the mapper schedules in SSA order, and the
executor's wave semantics depend on it), rounds partitioning the stage
list with at most `n_partitions` resident stages (S-ROUND), partition
assignments in range (S-PART), and the stage cost fields agreeing with
an independent `OpCost` recomputation (S-COST, warn — cost drift makes
the latency model lie, it does not corrupt results). The schedule's
trace is re-verified through `verify_ir` (rescale-before-overflow and
the rest of the T-rules ride along).

Per-pass diffing (`verify_pass`): called by `optimize_trace(...,
verify=True)` / `PassManager(verify=True)` after every applied pass,
so the first invariant violation is attributed to the pass that
introduced it (P-IFACE/P-CONST plus the structural T-rule sweep on
the pass's output; the semantic rules — level budget, scale widths,
liveness — are whole-pipeline invariants deferred to the final full
verification, keeping per-pass overhead inside fig17's <5%-of-
compile-wall gate).
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Set, Tuple

from repro_torch.analysis.findings import Report
from repro_torch.analysis.verify_ir import verify_trace
from repro_torch.core.pipeline import PipelineSchedule
from repro_torch.core.trace import FheTrace, evk_bytes, op_cost

_KS_KINDS = ("hmul", "rotate", "conjugate")


def _recompute_stage(params, mem, ops) -> Tuple[int, int, float, int]:
    """(raw_const_bytes, evk_shared_const_bytes, compute_s, out_bytes) —
    mirrors core.pipeline._stage_cost plus the load-save mapper's
    shared-evk correction, so either mapper's stages verify clean."""
    const_b, comp, out_b = 0, 0.0, 0
    n_ks = 0
    for o in ops:
        c = op_cost(params, o)
        const_b += c.const_bytes
        comp += mem.compute_seconds(c, params.n)
        out_b = c.out_bytes
        if o.kind in _KS_KINDS:
            n_ks += 1
    shared = const_b
    if n_ks > 1:
        shared -= (n_ks - 1) * evk_bytes(params)
    return const_b, shared, comp, out_b


def verify_schedule(schedule: PipelineSchedule, *,
                    start_level: Optional[int] = None,
                    bootstrap_to: Optional[int] = None,
                    include_trace: bool = True,
                    subject: str = "") -> Report:
    rep = Report("schedule", subject)
    t0 = time.perf_counter()
    trace = schedule.trace
    if include_trace and trace is not None:
        rep.extend(verify_trace(trace, start_level=start_level,
                                bootstrap_to=bootstrap_to,
                                subject=subject))

    mem = schedule.mem
    # coverage: exactly one stage slot per trace compute op
    pos: Dict[int, int] = {}
    flat = 0
    for st in schedule.stages:
        for op in st.ops:
            if op.idx in pos:
                rep.add("S-DUP", f"stage {st.idx}",
                        f"op {op.idx} ({op.kind}) already scheduled "
                        f"earlier in the stage order",
                        "each op must run exactly once",
                        op_idx=op.idx, stage=st.idx)
            else:
                pos[op.idx] = flat
            flat += 1
    if trace is not None:
        for op in trace.compute_ops():
            if op.idx not in pos:
                rep.add("S-COVER", f"op {op.idx} ({op.kind})",
                        "not covered by any stage",
                        "re-map the trace", op_idx=op.idx)
        compute_idx = {o.idx for o in trace.compute_ops()}
        # topological order across stage boundaries
        for st in schedule.stages:
            for op in st.ops:
                for a in op.args:
                    if a in compute_idx and a in pos \
                            and pos[a] >= pos.get(op.idx, -1) >= 0:
                        rep.add(
                            "S-ORDER", f"stage {st.idx}",
                            f"op {op.idx} ({op.kind}) consumes op {a} "
                            f"scheduled at or after it",
                            "stages must respect SSA dataflow order",
                            op_idx=op.idx, stage=st.idx)

    # rounds partition the stage list, in order, bounded by n_partitions
    flat_rounds = [st for rnd in schedule.rounds for st in rnd]
    if [st.idx for st in flat_rounds] != [st.idx for st in schedule.stages]:
        rep.add("S-ROUND", "rounds",
                f"rounds flatten to stages "
                f"{[st.idx for st in flat_rounds]} != "
                f"{[st.idx for st in schedule.stages]}",
                "rounds must partition the stage list in order")
    for ri, rnd in enumerate(schedule.rounds):
        if len(rnd) > mem.n_partitions:
            rep.add("S-ROUND", f"round {ri}",
                    f"{len(rnd)} resident stages > n_partitions="
                    f"{mem.n_partitions}",
                    "a round cannot hold more stages than partitions")

    for st in schedule.stages:
        if not 0 <= st.partition < mem.n_partitions:
            rep.add("S-PART", f"stage {st.idx}",
                    f"partition {st.partition} outside "
                    f"[0, {mem.n_partitions})", stage=st.idx)
        raw, shared, comp, out_b = _recompute_stage(
            schedule.params, mem, st.ops)
        if st.const_bytes not in (raw, shared):
            rep.add("S-COST", f"stage {st.idx}",
                    f"const_bytes={st.const_bytes} matches neither the "
                    f"raw ({raw}) nor evk-shared ({shared}) "
                    f"recomputation", stage=st.idx)
        if abs(st.compute_s - comp) > 1e-6 * max(abs(comp), 1e-30):
            rep.add("S-COST", f"stage {st.idx}",
                    f"compute_s={st.compute_s:.6e} vs recomputed "
                    f"{comp:.6e}", stage=st.idx)
        if st.out_bytes != out_b:
            rep.add("S-COST", f"stage {st.idx}",
                    f"out_bytes={st.out_bytes} vs recomputed {out_b}",
                    stage=st.idx)
    rep.wall_s = time.perf_counter() - t0
    return rep


# ---------------------------------------------------------------------------
# per-pass semantic diffing
# ---------------------------------------------------------------------------

def _base_const_refs(trace: FheTrace) -> Set[str]:
    """Base plaintext-constant names a trace references: plain
    ``meta['const']`` bindings plus the ``ref`` leaves of derived
    constant expressions (compiler/ir.py cexpr grammar)."""
    names: Set[str] = set()
    stack = []
    for op in trace.ops:
        meta = op.meta
        if "cexpr" in meta:
            stack.append(meta["cexpr"])
        elif "const" in meta:
            names.add(meta["const"])
    while stack:                    # iterative: runs twice per pass diff
        e = stack.pop()
        if not isinstance(e, tuple) or not e:
            continue
        if e[0] == "ref":
            names.add(e[1])
        elif e[0] == "rot":
            stack.append(e[1])
        else:                       # ("mul"|"add", a, b)
            stack.append(e[1])
            stack.append(e[2])
    return names


def _input_slots(trace: FheTrace):
    return sorted(trace.ops[i].meta.get("slot")
                  for i in trace.inputs
                  if 0 <= i < len(trace.ops))


def verify_pass(before: FheTrace, after: FheTrace, *,
                check_budget: bool = False,
                start_level: Optional[int] = None,
                bootstrap_to: Optional[int] = None,
                subject: str = "") -> Report:
    """Diff one pass application: interface preservation (P-IFACE),
    constant provenance (P-CONST), and a trace-IR sweep on the output.
    ``check_budget`` defaults off — mid-pipeline traces may be legally
    deeper than the chain until bootstrap insertion runs — and in that
    mode the sweep is structural-only: scale/liveness are whole-
    pipeline invariants the final full verification re-checks, so
    rerunning them after every pass would only inflate the verify
    overhead that fig17's gate bounds."""
    rep = Report("pass", subject)
    t0 = time.perf_counter()
    if len(after.inputs) != len(before.inputs):
        rep.add("P-IFACE", "inputs",
                f"{len(before.inputs)} inputs -> {len(after.inputs)}",
                "passes must not add or drop program inputs")
    elif _input_slots(after) != _input_slots(before):
        rep.add("P-IFACE", "inputs",
                f"input slot bindings changed: "
                f"{_input_slots(before)} -> {_input_slots(after)}")
    if len(after.outputs) != len(before.outputs):
        rep.add("P-IFACE", "outputs",
                f"{len(before.outputs)} outputs -> "
                f"{len(after.outputs)}",
                "passes must preserve the output arity")
    new_refs = _base_const_refs(after) - _base_const_refs(before)
    if new_refs:
        rep.add("P-CONST", "consts",
                f"references unknown base constant(s) "
                f"{sorted(new_refs)}",
                "derived constants must be expressions over the "
                "input trace's names")
    rep.extend(verify_trace(after, check_budget=check_budget,
                            structural_only=not check_budget,
                            start_level=start_level,
                            bootstrap_to=bootstrap_to, subject=subject))
    rep.wall_s = time.perf_counter() - t0
    return rep


__all__ = ["verify_schedule", "verify_pass"]
