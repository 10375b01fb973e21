"""`PimBackend` — discrete-event simulation of a lowered PIM
instruction stream behind the runtime's backend contract
(``execute(schedule, batch, ...) -> seconds``, DESIGN.md §9/§10).

Schedules are lowered once (layout + instruction stream memoized per
schedule object — schedules themselves live in the CompileCache, so
steady-state serving never re-lowers) and every batch replays the
stream on a virtual clock with the same round semantics as the
analytic backend: within a round, a stage's busy time is its constant
LOAD (KeyCache-aware: a resident stage loads nothing) plus
max(compute+movement, output transfer) scaled by the batch; the round
costs its worst stage plus pipeline fill. With a ``degenerate`` arch
the per-stage buckets equal `PipelineSchedule.stage_times` to float
precision, so AnalyticBackend and PimBackend(flat) agree within 1% —
the regression that anchors the hierarchy model to the flat one.

Per-workload compute/movement/load breakdowns of the last executed
batch are kept on the backend (`last_breakdown`) for
benchmarks/fig19_pim.py.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.core.pipeline import PipelineSchedule
from repro_torch.pim.arch import PimArch, arch_for_memory_model, get_arch
from repro_torch.pim.isa import PimProgram
from repro_torch.pim.layout import LayoutPlan, plan_layout
from repro_torch.pim.lower import lower_schedule


class PimBackend:
    """Hierarchical-hardware sibling of AnalyticBackend: same contract,
    same virtual clock, but every second is accounted instruction by
    instruction on a `PimArch` instead of the flat MemoryModel."""

    def __init__(self, arch: Optional[PimArch] = None,
                 preset: str = "fhemem", verify: bool = False):
        """``verify=True`` asks for the static hazard analyzer over every
        freshly lowered program, which this package does not have yet: it
        raises NotImplementedError."""
        if verify:
            raise NotImplementedError(
                "PimBackend(verify=True) needs repro_torch.analysis, "
                "which is not yet ported")
        self.arch = arch if arch is not None else get_arch(preset)
        # keyed by id(schedule); the schedule reference is retained so
        # a recycled id can never alias a dead schedule
        self._lowered: Dict[int, Tuple[PipelineSchedule, LayoutPlan,
                                       PimProgram]] = {}
        # workload -> per-stage {stage, load_s, compute_s, move_s} of
        # the most recent batch (fig19's breakdown source)
        self.last_breakdown: Dict[str, List[dict]] = {}

    def program_for(self, schedule: PipelineSchedule) -> PimProgram:
        key = id(schedule)
        hit = self._lowered.get(key)
        if hit is None or hit[0] is not schedule:
            layout = plan_layout(schedule, self.arch)
            prog = lower_schedule(schedule, self.arch, layout)
            self._lowered[key] = (schedule, layout, prog)
            return prog
        return hit[2]

    def layout_for(self, schedule: PipelineSchedule) -> LayoutPlan:
        self.program_for(schedule)
        return self._lowered[id(schedule)][1]

    def round_seconds(self, schedule: PipelineSchedule, rnd, b: int, *,
                      key_cache, metrics, workload: str,
                      breakdown: Optional[List[dict]] = None,
                      obs=None) -> float:
        """One pipeline round of the lowered instruction stream at batch
        occupancy ``b`` — the simulation unit the fleet's
        continuous-batching path steps (same contract as
        AnalyticBackend.round_seconds).

        With ``obs`` (repro_torch.obs.ExecObs) carrying a tracer, the round
        emits a ``round`` span plus per-stage ``stage`` spans
        attributed all the way down to the lowered ISA: per
        instruction-class (LOAD/ROWOP/NTT/XFER/STORE) and per-bank
        cycle counts from the instruction stream — the trace-view
        analogue of fig19's breakdown. With ``metrics.telemetry``
        armed (obs supplies the timeline origin even when its tracer
        is None), the round also steps the bank-utilization and
        movement-bandwidth time series (`_emit_telemetry`)."""
        prog = self.program_for(schedule)
        round_times = []
        rows = []
        for st in rnd:
            load_s, comp_s, move_s, out_s = prog.stage_seconds(st.idx)
            if schedule.reload_per_op:
                # constants overflow the bank: every input re-streams
                load_s *= b
            elif key_cache is not None:
                _, _, load_s = key_cache.get_or_load(
                    (workload, "stage", st.idx), st.const_bytes)
            exec_s = b * (comp_s + move_s)
            xfer_s = b * out_s
            busy = load_s + max(exec_s, xfer_s)
            metrics.occupancy.add(st.partition, busy)
            round_times.append((busy, exec_s, xfer_s))
            row = {"stage": st.idx, "partition": st.partition,
                   "load_s": load_s, "compute_s": b * comp_s,
                   "move_s": b * move_s + xfer_s, "busy_s": busy}
            rows.append(row)
            if breakdown is not None:
                breakdown.append(row)
        worst = max(t[0] for t in round_times)
        fill = sum(max(e, x) / b for (_, e, x) in round_times)
        tel = metrics.telemetry
        if tel is not None and obs is not None:
            self._emit_telemetry(tel, prog, rnd, rows, b,
                                 obs.t0, worst + fill)
        if obs is not None and obs.tracer is not None:
            rspan = obs.tracer.begin("round", obs.t0, parent=obs.parent,
                                     track=obs.track, n_stages=len(rnd),
                                     b=b)
            for st, row in zip(rnd, rows):
                obs.tracer.span(
                    "stage", obs.t0, obs.t0 + row["busy_s"], parent=rspan,
                    track=obs.track, stage=st.idx,
                    partition=st.partition, load_s=row["load_s"],
                    compute_s=row["compute_s"], move_s=row["move_s"],
                    isa_cycles={k: round(v, 4) for k, v in
                                prog.stage_class_cycles(st.idx).items()},
                    bank_cycles={str(k): round(v, 4) for k, v in
                                 prog.stage_bank_cycles(st.idx).items()})
            obs.tracer.end(rspan, obs.t0 + worst + fill)
        return worst + fill

    @staticmethod
    def stage_phase(prog: PimProgram, stage: int) -> str:
        """Dominant ISA class of a lowered stage — the ``phase`` label
        on the utilization series ("what was the fabric doing"):
        ntt / modmul / move / load by argmax cycle share."""
        cls = prog.stage_class_cycles(stage)
        groups = (("ntt", cls["NTT"]), ("modmul", cls["ROWOP"]),
                  ("move", cls["XFER"] + cls["STORE"]),
                  ("load", cls["LOAD"]))
        return max(groups, key=lambda kv: kv[1])[0]

    def _emit_telemetry(self, tel, prog: PimProgram, rnd, rows,
                        b: int, t0: float, round_s: float) -> None:
        """Per-round series points, stamped at the round's end on the
        DES timeline: per-bank busy seconds/cycles and utilization
        (busy over the round's wall — strictly < 1 whenever any other
        stage contributes fill), and per-scope movement bytes
        normalized against the arch's peak link bandwidth so presets
        are directly comparable."""
        t_end = t0 + round_s
        arch = self.arch
        for st, row in zip(rnd, rows):
            ch, bk = arch.bank_coords(st.partition)
            phase = self.stage_phase(prog, st.idx)
            cls = prog.stage_class_cycles(st.idx)
            exec_cycles = b * (cls["ROWOP"] + cls["NTT"] + cls["XFER"]
                               + cls["STORE"])
            tel.counter("fhe_pim_bank_busy_seconds",
                        channel=ch, bank=bk).inc(t_end, row["busy_s"])
            tel.counter("fhe_pim_bank_busy_cycles", channel=ch, bank=bk,
                        phase=phase).inc(t_end, exec_cycles)
            tel.gauge("fhe_pim_bank_utilization", channel=ch, bank=bk,
                      phase=phase).set(t_end, row["busy_s"] / round_s)
            for scope, nbytes in sorted(
                    prog.stage_scope_bytes(st.idx).items()):
                moved = b * nbytes
                tel.counter("fhe_pim_move_bytes", scope=scope).inc(
                    t_end, moved)
                tel.gauge("fhe_pim_move_bw_frac", scope=scope).set(
                    t_end, (moved / round_s) / arch.scope_bw(scope))

    def execute(self, schedule: PipelineSchedule, batch, *,
                key_cache, metrics, workload: str, obs=None) -> float:
        b = max(1, batch.n_ciphertexts)
        breakdown: List[dict] = []
        total = 0.0
        for rnd in schedule.rounds:
            total += self.round_seconds(
                schedule, rnd, b, key_cache=key_cache, metrics=metrics,
                workload=workload, breakdown=breakdown,
                obs=obs.at(obs.t0 + total) if obs is not None else None)
        self.last_breakdown[workload] = breakdown
        return total


def resolve_pim_backend(mem, verify: bool = False) -> PimBackend:
    """Backend for `resolve_backend("pim", ...)`: recover the arch the
    MemoryModel was projected from (preset match), else wrap the mem in
    a degenerate arch that bills identically to AnalyticBackend."""
    return PimBackend(arch=arch_for_memory_model(mem), verify=verify)
