"""Mutation harness: seed one known-bad artifact per analyzer rule.

Each rule in `repro_torch.analysis.findings.RULES` has a mutator here that
takes a CLEAN artifact (trace / schedule / lowered PIM program) and
corrupts it in exactly the way the rule exists to catch. The
negative-path tests (tests/test_analysis.py) and the lint CLI's
``--prove`` mode iterate these registries to prove every rule fires —
a verifier rule without a firing mutation is dead code.

Mutators never modify their input: traces are cloned through
`compiler.ir.clone_ops`, schedules rebuilt with cloned ops (stage ops
keep sharing the cloned trace's op objects, like real schedules),
programs/layouts rebuilt with fresh instruction/placement lists.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

from repro_torch.compiler.ir import clone_ops
from repro_torch.core.pipeline import PipelineSchedule, Stage
from repro_torch.core.trace import FheOp, FheTrace
from repro_torch.pim.arch import PimArch
from repro_torch.pim.isa import PimInstr, PimProgram
from repro_torch.pim.layout import LayoutPlan, Placement, StageLayout


# ---------------------------------------------------------------------------
# deep-copy helpers (schedules share op objects with their trace — the
# clones must too, or index-based checks would pass vacuously)
# ---------------------------------------------------------------------------

def clone_trace(trace: FheTrace) -> FheTrace:
    return FheTrace(clone_ops(trace), list(trace.inputs),
                    list(trace.outputs), list(trace.consts))


def clone_schedule(schedule: PipelineSchedule) -> PipelineSchedule:
    trace = clone_trace(schedule.trace) if schedule.trace is not None \
        else None
    by_idx = {op.idx: op for op in trace.ops} if trace is not None else {}
    stages = [Stage(st.idx,
                    [by_idx.get(o.idx, o) for o in st.ops],
                    st.partition, st.const_bytes, st.compute_s,
                    st.out_bytes)
              for st in schedule.stages]
    stage_by_idx = {st.idx: st for st in stages}
    rounds = [[stage_by_idx[st.idx] for st in rnd]
              for rnd in schedule.rounds]
    return PipelineSchedule(stages, rounds, schedule.params, schedule.mem,
                            reload_per_op=schedule.reload_per_op,
                            trace=trace)


def clone_program(program: PimProgram) -> PimProgram:
    return PimProgram(program.arch_name, program.freq_hz,
                      list(program.instrs), program.n_stages)


def clone_layout(layout: LayoutPlan) -> LayoutPlan:
    return LayoutPlan(layout.arch,
                      [StageLayout(sl.stage_idx, sl.home_channel,
                                   sl.home_bank, list(sl.placements),
                                   sl.spill_bytes_bank,
                                   sl.spill_bytes_channel)
                       for sl in layout.stages])


def _pick(ops, pred, what: str) -> FheOp:
    for op in ops:
        if pred(op):
            return op
    raise AssertionError(
        f"mutation harness needs a clean artifact containing {what}")


# ---------------------------------------------------------------------------
# trace mutators (T-*)
# ---------------------------------------------------------------------------

def _mut_def_use(trace: FheTrace) -> FheTrace:
    t = clone_trace(trace)
    op = _pick(t.ops, lambda o: o.args, "an op with operands")
    op.args = (op.idx,) + op.args[1:]          # self-reference
    return t


def _mut_index(trace: FheTrace) -> FheTrace:
    t = clone_trace(trace)
    op = _pick(t.ops, lambda o: o.kind not in ("input", "const"),
               "a compute op")
    op.idx += 1
    return t


def _mut_kind(trace: FheTrace) -> FheTrace:
    t = clone_trace(trace)
    op = _pick(t.ops, lambda o: o.kind not in ("input", "const"),
               "a compute op")
    op.kind = "frobnicate"
    return t


def _mut_arity(trace: FheTrace) -> FheTrace:
    t = clone_trace(trace)
    op = _pick(t.ops, lambda o: o.kind in ("hmul", "hadd", "hsub"),
               "a binary op")
    op.args = op.args[:1]
    return t


def _mut_meta(trace: FheTrace) -> FheTrace:
    t = clone_trace(trace)
    op = _pick(t.ops,
               lambda o: o.kind == "rotate" or
               (o.kind in ("pmul", "padd") and
                ("const" in o.meta or "cexpr" in o.meta)),
               "a rotate or pmul/padd op")
    if op.kind == "rotate":
        op.meta.pop("step", None)
    else:
        op.meta.pop("const", None)
        op.meta.pop("cexpr", None)
    return t


def _mut_iface(trace: FheTrace) -> FheTrace:
    t = clone_trace(trace)
    t.outputs.append(len(t.ops) + 7)           # dangling output
    return t


def _mut_level(trace: FheTrace) -> FheTrace:
    t = clone_trace(trace)
    op = _pick(t.ops,
               lambda o: o.kind not in ("input", "const")
               and o.level is not None, "a level-annotated compute op")
    op.level += 1
    return t


def _mut_budget(trace: FheTrace) -> FheTrace:
    # graft a 64-deep eager-product chain onto the first output: one
    # level burned per hmul exhausts any realistic modulus chain
    t = clone_trace(trace)
    src = t.outputs[0]
    for _ in range(64):
        t.ops.append(FheOp(len(t.ops), "hmul", (src, src), {}))
        src = len(t.ops) - 1
    t.outputs = [src]
    return t


def _mut_scale(trace: FheTrace) -> FheTrace:
    # synthetic seed: a lazy double-width product meets a single-width
    # value in an hadd
    ops = [FheOp(0, "input", (), {"slot": 0}),
           FheOp(1, "input", (), {"slot": 1}),
           FheOp(2, "hmul", (0, 1), {"lazy": True}),
           FheOp(3, "hadd", (2, 0), {})]
    return FheTrace(ops, inputs=[0, 1], outputs=[3], consts=[])


def _mut_overflow(trace: FheTrace) -> FheTrace:
    # synthetic seed: lazy product of lazy products — width 4, no
    # rescale anywhere
    ops = [FheOp(0, "input", (), {"slot": 0}),
           FheOp(1, "input", (), {"slot": 1}),
           FheOp(2, "hmul", (0, 1), {"lazy": True}),
           FheOp(3, "hmul", (2, 2), {"lazy": True})]
    return FheTrace(ops, inputs=[0, 1], outputs=[3], consts=[])


def _mut_dead(trace: FheTrace) -> FheTrace:
    t = clone_trace(trace)
    src = t.inputs[0]
    t.ops.append(FheOp(len(t.ops), "hadd", (src, src), {}))
    return t


def _mut_unused_in(trace: FheTrace) -> FheTrace:
    t = clone_trace(trace)
    t.ops.append(FheOp(len(t.ops), "input", (), {"slot": 99}))
    t.inputs.append(len(t.ops) - 1)
    return t


TRACE_MUTATIONS: Dict[str, Callable[[FheTrace], FheTrace]] = {
    "T-DEF-USE": _mut_def_use,
    "T-INDEX": _mut_index,
    "T-KIND": _mut_kind,
    "T-ARITY": _mut_arity,
    "T-META": _mut_meta,
    "T-IFACE": _mut_iface,
    "T-LEVEL": _mut_level,
    "T-BUDGET": _mut_budget,
    "T-SCALE": _mut_scale,
    "T-OVERFLOW": _mut_overflow,
    "T-DEAD": _mut_dead,
    "T-UNUSED-IN": _mut_unused_in,
}


# ---------------------------------------------------------------------------
# pass-level corruptions (P-*) — applied THROUGH the pass pipeline via
# CorruptingPass so PassManager(verify=True) attribution is exercised
# ---------------------------------------------------------------------------

def _mut_pass_iface(trace: FheTrace) -> FheTrace:
    t = clone_trace(trace)
    t.outputs = t.outputs[:-1]                  # drop an output
    return t


def _mut_pass_const(trace: FheTrace) -> FheTrace:
    t = clone_trace(trace)
    op = _pick(t.ops, lambda o: "const" in o.meta or "cexpr" in o.meta,
               "a const-bearing op")
    op.meta.pop("cexpr", None)
    op.meta["const"] = "__phantom_const__"
    return t


PASS_MUTATIONS: Dict[str, Callable[[FheTrace], FheTrace]] = {
    "P-IFACE": _mut_pass_iface,
    "P-CONST": _mut_pass_const,
}


class CorruptingPass:
    """A pass-pipeline stage that applies a seeded corruption — drop it
    into `optimize_trace(..., passes=[...])` to prove
    `PassManager(verify=True)` attributes the violation to it."""

    may_increase_cost = True        # exempt from the cost-revert guard

    def __init__(self, rule: str, name: str = "corrupt"):
        self.rule = rule
        self.name = name
        self._fn = (PASS_MUTATIONS.get(rule) or TRACE_MUTATIONS[rule])

    def run(self, trace: FheTrace, params, config) -> FheTrace:
        return self._fn(trace)


# ---------------------------------------------------------------------------
# schedule mutators (S-*)
# ---------------------------------------------------------------------------

def _smut_cover(schedule: PipelineSchedule) -> PipelineSchedule:
    s = clone_schedule(schedule)
    st = max(s.stages, key=lambda st: len(st.ops))
    st.ops.pop()
    return s


def _smut_dup(schedule: PipelineSchedule) -> PipelineSchedule:
    s = clone_schedule(schedule)
    s.stages[-1].ops.append(s.stages[0].ops[0])
    return s


def _smut_order(schedule: PipelineSchedule) -> PipelineSchedule:
    s = clone_schedule(schedule)
    compute_idx = {o.idx for o in s.trace.compute_ops()}
    for st in reversed(s.stages):
        for op in reversed(st.ops):
            if any(a in compute_idx for a in op.args):
                st.ops.remove(op)
                s.stages[0].ops.insert(0, op)   # consumer before producer
                return s
    raise AssertionError("mutation harness needs a schedule with a "
                         "compute-to-compute dataflow edge")


def _smut_round(schedule: PipelineSchedule) -> PipelineSchedule:
    s = clone_schedule(schedule)
    s.rounds = s.rounds[:-1]
    return s


def _smut_part(schedule: PipelineSchedule) -> PipelineSchedule:
    s = clone_schedule(schedule)
    s.stages[0].partition = s.mem.n_partitions + 1
    return s


def _smut_cost(schedule: PipelineSchedule) -> PipelineSchedule:
    s = clone_schedule(schedule)
    s.stages[0].const_bytes += 987654321
    return s


SCHEDULE_MUTATIONS: Dict[str, Callable[[PipelineSchedule],
                                       PipelineSchedule]] = {
    "S-COVER": _smut_cover,
    "S-DUP": _smut_dup,
    "S-ORDER": _smut_order,
    "S-ROUND": _smut_round,
    "S-PART": _smut_part,
    "S-COST": _smut_cost,
}


# ---------------------------------------------------------------------------
# PIM program/layout mutators (M-*)
# ---------------------------------------------------------------------------

_PimMut = Callable[[PimProgram, PipelineSchedule, LayoutPlan, PimArch],
                   Tuple[PimProgram, LayoutPlan]]


def _pmut_opcode(prog, schedule, layout, arch):
    p = clone_program(prog)
    p.instrs[0] = dataclasses.replace(p.instrs[0], opcode="JMP")
    return p, layout


def _find_dep_pair(schedule: PipelineSchedule):
    """(stage_idx, producer_idx, consumer_idx) with both ops in one
    stage and a dataflow edge between them."""
    for st in schedule.stages:
        in_stage = {o.idx for o in st.ops}
        for op in st.ops:
            for a in op.args:
                if a in in_stage and a != op.idx:
                    return st.idx, a, op.idx
    raise AssertionError("mutation harness needs a stage containing a "
                         "dataflow-dependent op pair")


def _pmut_order(prog, schedule, layout, arch):
    p = clone_program(prog)
    sidx, producer, consumer = _find_dep_pair(schedule)
    # identity-based split: frozen PimInstrs compare by value, and
    # distinct instructions can be equal
    prod_ids = {id(i) for i in p.instrs
                if i.stage == sidx and i.op_idx == producer}
    prod = [i for i in p.instrs if id(i) in prod_ids]
    rest = [i for i in p.instrs if id(i) not in prod_ids]
    # reinsert the producer's block right after the consumer's last instr
    last_cons = max(k for k, i in enumerate(rest)
                    if i.stage == sidx and i.op_idx == consumer)
    p.instrs = rest[:last_cons + 1] + prod + rest[last_cons + 1:]
    return p, layout


def _pmut_load_order(prog, schedule, layout, arch):
    p = clone_program(prog)
    for k, ins in enumerate(p.instrs):
        if ins.opcode == "LOAD":
            nxt = [j for j, x in enumerate(p.instrs)
                   if x.stage == ins.stage and j > k
                   and x.opcode in ("ROWOP", "NTT")]
            if nxt:
                j = nxt[0]
                p.instrs[k], p.instrs[j] = p.instrs[j], p.instrs[k]
                return p, layout
    raise AssertionError("mutation harness needs a stage with a LOAD "
                         "followed by compute")


def _pmut_store_order(prog, schedule, layout, arch):
    p = clone_program(prog)
    for k in range(len(p.instrs) - 1, 0, -1):
        ins = p.instrs[k]
        prev = p.instrs[k - 1]
        if ins.opcode == "STORE" and prev.stage == ins.stage \
                and prev.opcode != "STORE":
            p.instrs[k], p.instrs[k - 1] = prev, ins
            return p, layout
    raise AssertionError("mutation harness needs a STORE preceded by "
                         "same-stage work")


def _pmut_orphan(prog, schedule, layout, arch):
    p = clone_program(prog)
    for k, ins in enumerate(p.instrs):
        if ins.opcode == "STORE" \
                and schedule.stages[ins.stage].out_bytes:
            del p.instrs[k]
            return p, layout
    raise AssertionError("mutation harness needs a STORE for a stage "
                         "with output bytes")


def _pmut_place(prog, schedule, layout, arch):
    lay = clone_layout(layout)
    for sl in lay.stages:
        if sl.placements:
            sl.placements.pop(0)
            return prog, lay
    raise AssertionError("mutation harness needs a layout with "
                         "placements")


def _pmut_cap(prog, schedule, layout, arch):
    lay = clone_layout(layout)
    for sl in lay.stages:
        if sl.placements:
            p0: Placement = sl.placements[0]
            sl.placements[0] = dataclasses.replace(
                p0, nbytes=arch.subarray_bytes + 1)
            return prog, lay
    raise AssertionError("mutation harness needs a layout with "
                         "placements")


def _pmut_bal(prog, schedule, layout, arch):
    p = clone_program(prog)
    # pick a non-bootstrap round with >= 2 stages and inflate its
    # busiest stage far past the analyzer's imbalance ratio
    for rnd in schedule.rounds:
        if len(rnd) < 2 or any(op.kind == "bootstrap"
                               for st in rnd for op in st.ops):
            continue
        stage_cycles = {st.idx: sum(i.cycles for i in p.instrs
                                    if i.stage == st.idx) for st in rnd}
        hot = max(stage_cycles, key=stage_cycles.get)
        p.instrs = [dataclasses.replace(i, cycles=i.cycles * 1e7)
                    if i.stage == hot else i for i in p.instrs]
        return p, layout
    raise AssertionError("mutation harness needs a bootstrap-free "
                         "round with >= 2 stages")


PIM_MUTATIONS: Dict[str, _PimMut] = {
    "M-OPCODE": _pmut_opcode,
    "M-ORDER": _pmut_order,
    "M-LOAD-ORDER": _pmut_load_order,
    "M-STORE-ORDER": _pmut_store_order,
    "M-ORPHAN": _pmut_orphan,
    "M-PLACE": _pmut_place,
    "M-CAP": _pmut_cap,
    "M-BAL": _pmut_bal,
}


ALL_MUTATIONS: List[str] = (list(TRACE_MUTATIONS) + list(PASS_MUTATIONS)
                            + list(SCHEDULE_MUTATIONS)
                            + list(PIM_MUTATIONS))


# ---------------------------------------------------------------------------
# clean artifact bundle for tests and `lint --prove`
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Artifacts:
    """One consistent (trace -> schedule -> layout -> program) chain on
    the smoke parameter point — verifies clean, mutates dirty."""
    params: object
    mem: object
    arch: PimArch
    start_level: int
    trace: FheTrace
    schedule: PipelineSchedule
    layout: LayoutPlan
    program: PimProgram


def make_clean_artifacts(workload: str = "matvec",
                         preset: str = "fhemem", *,
                         optimize: bool = True,
                         const_budget_frac: float = 0.005) -> Artifacts:
    # const_budget_frac deliberately tiny: the smoke point's constants
    # are small, and the harness needs MULTI-stage schedules (rounds
    # with >= 2 resident banks) so the ordering/balance mutations have
    # something to corrupt
    """Trace, compile, map, place and lower one registered workload on
    the smoke parameter point (same point serve_fhe --smoke uses).
    Deferred imports keep `repro_torch.analysis.mutate` importable without
    the runtime stack."""
    from repro_torch.compiler import PassConfig, optimize_trace
    from repro_torch.core.params import test_params
    from repro_torch.core.pipeline import generate_load_save_pipeline
    from repro_torch.core.trace import infer_levels, trace_program
    from repro_torch.pim.arch import get_arch, memory_model
    from repro_torch.pim.layout import plan_layout
    from repro_torch.pim.lower import lower_schedule
    from repro_torch.runtime import workloads as wl

    table = {
        "helr": (wl.make_helr_iter(), 2, wl.HELR_CONSTS),
        "lola": (wl.lola_infer, 1, wl.LOLA_CONSTS),
        "matvec": (wl.make_matvec(16), 1, wl.matvec_consts(16)),
        "poly": (wl.make_poly_eval(12), 1, wl.poly_consts(12)),
    }
    fn, n_in, consts = table[workload]
    params = test_params(log_n=10, n_levels=8, dnum=2)
    start = params.n_levels - 1
    trace = trace_program(fn, n_in, consts)
    if optimize:
        trace.ops[trace.inputs[0]].level = start   # record the start
        trace, _ = optimize_trace(
            trace, params, PassConfig(start_level=start))
    else:
        infer_levels(trace, start_level=start)
    mem = memory_model(preset)
    schedule = generate_load_save_pipeline(trace, params, mem,
                                           const_budget_frac)
    arch = get_arch(preset)
    layout = plan_layout(schedule, arch)
    program = lower_schedule(schedule, arch, layout)
    return Artifacts(params, mem, arch, start, trace, schedule, layout,
                     program)


__all__ = ["TRACE_MUTATIONS", "PASS_MUTATIONS", "SCHEDULE_MUTATIONS",
           "PIM_MUTATIONS", "ALL_MUTATIONS", "CorruptingPass",
           "Artifacts", "make_clean_artifacts",
           "clone_trace", "clone_schedule", "clone_program",
           "clone_layout"]
