"""Hazard analyzer over lowered `PimProgram` instruction streams.

The lowerer (repro_torch.pim.lower) emits each stage's instructions in a
fixed discipline: the constant LOAD first, then per-op ROWOP/NTT/XFER
blocks in SSA dataflow order, then the STORE that ships the stage
output. The bank executes a stage's stream in order, so any violation
of that discipline is a real hazard, not a style issue:

* ``M-ORDER``       RAW — a consumer's rows are computed before its
                    producer's rows exist in the bank.
* ``M-LOAD-ORDER``  rows multiplied against constants still in flight
                    on the load channel.
* ``M-STORE-ORDER`` WAR — the STORE shipped output rows that later
                    instructions of the same stage still mutate.
* ``M-ORPHAN``      LOAD/STORE present without matching stage
                    const/output bytes (or missing when required).
* ``M-PLACE``/``M-CAP`` — the layout invariants repro_torch.pim.layout
                    promises (exactly-once limb placement, per-
                    (round, generation) subarray capacity), rechecked
                    independently of the planner.
* ``M-BAL``         (warn) bank utilization imbalance within one
                    pipeline round — resident stages run concurrently,
                    so a hot bank is wasted parallel hardware.

This is the static precondition for the ROADMAP's movement-aware
rotation scheduling: once the compiler starts reordering XFERs against
ROWOPs, this analyzer is the gate that keeps the reordering honest.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.findings import Report
from repro_torch.core.pipeline import PipelineSchedule
from repro_torch.pim.arch import PimArch
from repro_torch.pim.isa import OPCODES, PimInstr, PimProgram
from repro_torch.pim.layout import LayoutPlan, _stage_limbs


def _locus(i: int, ins: PimInstr) -> str:
    return f"instr {i} ({ins.opcode} stage {ins.stage})"


def _structural(rep: Report, program: PimProgram) -> None:
    for i, ins in enumerate(program.instrs):
        if ins.opcode not in OPCODES:
            rep.add("M-OPCODE", _locus(i, ins),
                    f"unknown opcode {ins.opcode!r}",
                    f"known: {', '.join(OPCODES)}", instr=i)
        if not 0 <= ins.stage < program.n_stages:
            rep.add("M-OPCODE", _locus(i, ins),
                    f"stage {ins.stage} outside "
                    f"[0, {program.n_stages})", instr=i)
        if ins.cycles < 0 or ins.nbytes < 0 or ins.rows < 0:
            rep.add("M-OPCODE", _locus(i, ins),
                    f"negative accounting: cycles={ins.cycles} "
                    f"nbytes={ins.nbytes} rows={ins.rows}", instr=i)


def _stage_streams(program: PimProgram) -> Dict[int, List[Tuple[int,
                                                                PimInstr]]]:
    out: Dict[int, List[Tuple[int, PimInstr]]] = {}
    for i, ins in enumerate(program.instrs):
        out.setdefault(ins.stage, []).append((i, ins))
    return out


def _ordering(rep: Report, program: PimProgram,
              schedule: Optional[PipelineSchedule]) -> None:
    """M-ORDER / M-LOAD-ORDER / M-STORE-ORDER / M-ORPHAN over each
    stage's instruction stream."""
    args_of = {}
    if schedule is not None and schedule.trace is not None:
        args_of = {op.idx: op.args for op in schedule.trace.ops}
    streams = _stage_streams(program)
    stages = schedule.stages if schedule is not None else None
    for sidx, stream in sorted(streams.items()):
        load_pos = [k for k, (_, ins) in enumerate(stream)
                    if ins.opcode == "LOAD"]
        store_pos = [k for k, (_, ins) in enumerate(stream)
                     if ins.opcode == "STORE"]
        # LOAD must precede every working instruction of the stage
        if load_pos:
            for i, ins in stream[:load_pos[0]]:
                rep.add("M-LOAD-ORDER", _locus(i, ins),
                        f"issues before the stage's constant LOAD "
                        f"(stream slot {load_pos[0]})",
                        "constants must be resident before any row op",
                        instr=i, stage=sidx)
        # STORE must come last: later work mutates shipped rows
        if store_pos:
            for i, ins in stream[store_pos[-1] + 1:]:
                rep.add("M-STORE-ORDER", _locus(i, ins),
                        "issues after the stage's STORE shipped the "
                        "output rows",
                        "move the STORE to the end of the stage",
                        instr=i, stage=sidx)
        # per-op RAW ordering from trace dataflow
        first: Dict[int, int] = {}
        last: Dict[int, int] = {}
        for k, (_, ins) in enumerate(stream):
            if ins.op_idx >= 0:
                first.setdefault(ins.op_idx, k)
                last[ins.op_idx] = k
        for op_idx, f0 in first.items():
            for a in args_of.get(op_idx, ()):
                if a in last and last[a] > f0:
                    i, ins = stream[f0]
                    rep.add("M-ORDER", _locus(i, ins),
                            f"op {op_idx} issues at stream slot {f0} "
                            f"before its producer op {a} finishes "
                            f"(slot {last[a]})",
                            "emit per-op blocks in SSA dataflow order",
                            instr=i, stage=sidx)
        # orphaned / missing stage-level instructions
        if stages is not None and 0 <= sidx < len(stages):
            st = stages[sidx]
            if st.const_bytes and not load_pos:
                rep.add("M-ORPHAN", f"stage {sidx}",
                        f"const_bytes={st.const_bytes} but no LOAD",
                        "the stage's constants are never streamed in",
                        stage=sidx)
            if load_pos and not st.const_bytes:
                i, ins = stream[load_pos[0]]
                rep.add("M-ORPHAN", _locus(i, ins),
                        "LOAD with const_bytes=0 on the stage",
                        instr=i, stage=sidx)
            if load_pos and st.const_bytes:
                i, ins = stream[load_pos[0]]
                if ins.nbytes != st.const_bytes:
                    rep.add("M-ORPHAN", _locus(i, ins),
                            f"LOAD nbytes={ins.nbytes} != stage "
                            f"const_bytes={st.const_bytes}",
                            instr=i, stage=sidx)
            if st.out_bytes and not store_pos:
                rep.add("M-ORPHAN", f"stage {sidx}",
                        f"out_bytes={st.out_bytes} but no STORE",
                        "the stage output never reaches the next bank",
                        stage=sidx)
            if store_pos and not st.out_bytes:
                i, ins = stream[store_pos[-1]]
                rep.add("M-ORPHAN", _locus(i, ins),
                        "STORE with out_bytes=0 on the stage",
                        instr=i, stage=sidx)


def _layout(rep: Report, schedule: PipelineSchedule, arch: PimArch,
            layout: LayoutPlan) -> None:
    """M-PLACE / M-CAP: recheck the layout invariants independently of
    the planner (same contract repro_torch.pim.layout documents)."""
    n = schedule.params.n
    for st in schedule.stages:
        sl = layout.stage(st.idx)
        expected: Dict[Tuple[int, int, int], int] = {}
        for op_idx, poly, limb, nbytes in _stage_limbs(st, n):
            expected[(op_idx, poly, limb)] = nbytes
        seen: Dict[Tuple[int, int, int], int] = {}
        for p in sl.placements:
            seen[(p.op_idx, p.poly, p.limb)] = \
                seen.get((p.op_idx, p.poly, p.limb), 0) + 1
        missing = [k for k in expected if k not in seen]
        dups = [k for k, c in seen.items() if c > 1]
        extra = [k for k in seen if k not in expected]
        if missing:
            rep.add("M-PLACE", f"stage {st.idx}",
                    f"{len(missing)} limb row(s) never placed; first: "
                    f"(op,poly,limb)={missing[0]}", stage=st.idx)
        if dups:
            rep.add("M-PLACE", f"stage {st.idx}",
                    f"{len(dups)} limb row(s) placed more than once; "
                    f"first: (op,poly,limb)={dups[0]}", stage=st.idx)
        if extra:
            rep.add("M-PLACE", f"stage {st.idx}",
                    f"{len(extra)} placement(s) for limbs the stage "
                    f"does not own; first: (op,poly,limb)={extra[0]}",
                    stage=st.idx)
    # capacity per (round, generation, subarray)
    for ri, rnd in enumerate(schedule.rounds):
        used: Dict[Tuple[int, int, int, int], int] = {}
        for st in rnd:
            if not 0 <= st.idx < len(layout.stages):
                continue
            for p in layout.stage(st.idx).placements:
                key = (p.generation, p.channel, p.bank, p.subarray)
                used[key] = used.get(key, 0) + p.nbytes
        for (gen, ch, bk, sa), nbytes in sorted(used.items()):
            if nbytes > arch.subarray_bytes:
                rep.add("M-CAP",
                        f"round {ri} gen {gen} subarray "
                        f"({ch},{bk},{sa})",
                        f"{nbytes} bytes > subarray_bytes="
                        f"{arch.subarray_bytes}",
                        "the layout planner must open a new residency "
                        "generation")


def _imbalance(rep: Report, program: PimProgram,
               schedule: PipelineSchedule, ratio: float) -> None:
    """M-BAL: within one round, resident banks run concurrently — a
    bank busier than `ratio`x the mean of the round's OTHER active
    banks is a utilization lint (threshold sits above the natural
    variance of the registered workloads; seeded mutations exceed it
    by construction)."""
    streams = _stage_streams(program)
    for ri, rnd in enumerate(schedule.rounds):
        # bootstrap rounds are known-unbalanced (one stage carries the
        # whole refresh); flagging them would drown the signal
        if any(op.kind == "bootstrap" for st in rnd for op in st.ops):
            continue
        busy: Dict[Tuple[int, int], float] = {}
        for st in rnd:
            for _, ins in streams.get(st.idx, ()):
                key = (ins.channel, ins.bank)
                busy[key] = busy.get(key, 0.0) + ins.cycles
        active = {k: v for k, v in busy.items() if v > 0}
        if len(active) < 2:
            continue
        worst_bank, worst = max(active.items(), key=lambda kv: kv[1])
        rest = [v for k, v in active.items() if k != worst_bank]
        mean_rest = sum(rest) / len(rest)
        if mean_rest > 0 and worst > ratio * mean_rest:
            rep.add("M-BAL", f"round {ri}",
                    f"bank {worst_bank} busy {worst:.0f} cycles vs "
                    f"{mean_rest:.0f} mean across the round's other "
                    f"banks ({worst / mean_rest:.0f}x > {ratio:.0f}x)",
                    "rebalance stage splitting or placement")


def analyze_program(program: PimProgram,
                    schedule: Optional[PipelineSchedule] = None,
                    arch: Optional[PimArch] = None,
                    layout: Optional[LayoutPlan] = None, *,
                    imbalance_ratio: float = 1000.0,
                    subject: str = "") -> Report:
    """Static hazard sweep over one lowered program. `schedule`
    unlocks the dataflow/orphan rules, `arch` + `layout` the placement
    and capacity rules — pass everything the call site has."""
    rep = Report("pim", subject)
    t0 = time.perf_counter()
    _structural(rep, program)
    _ordering(rep, program, schedule)
    if schedule is not None and arch is not None and layout is not None:
        _layout(rep, schedule, arch, layout)
    if schedule is not None:
        _imbalance(rep, program, schedule, imbalance_ratio)
    rep.wall_s = time.perf_counter() - t0
    return rep


__all__ = ["analyze_program"]
