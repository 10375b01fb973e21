"""Lower a compiled `PipelineSchedule` into a bank-level PIM
instruction stream (repro_torch.pim.isa) under a data layout
(repro_torch.pim.layout), with per-instruction cycle accounting from the
arch's cycle model (repro_torch.pim.arch).

Per compute op the lowerer consumes the same `OpCost` channels the
analytic model bills — plain modmul rows, keyswitch digit-
decomposition rows (weighted ``ks_modmul_weight``), NTT passes, and
the op's ``move_bytes`` data-movement channel — and emits ROWOP / NTT
/ XFER instructions on the stage's home bank. Hierarchy presets
additionally pay NTT inter-mat shuffles and spilled-limb traffic; a
``degenerate`` arch bills exactly the flat MemoryModel formula, so
summing a lowered stream reproduces `PipelineSchedule.stage_times` to
float precision (regression-tested in tests/test_pim.py).
"""
from __future__ import annotations

import math
from typing import List, Optional

from repro_torch.core.pipeline import PipelineSchedule
from repro_torch.core.trace import ct_bytes, op_cost
from repro_torch.pim.arch import PimArch
from repro_torch.pim.isa import PimInstr, PimProgram
from repro_torch.pim.layout import LayoutPlan, plan_layout


def lower_schedule(schedule: PipelineSchedule, arch: PimArch,
                   layout: Optional[LayoutPlan] = None) -> PimProgram:
    """Pure function of (schedule, arch[, layout]) — lowering twice
    yields identical streams (property-tested)."""
    if layout is None:
        layout = plan_layout(schedule, arch)
    params = schedule.params
    n = params.n
    f = arch.freq_hz
    instrs: List[PimInstr] = []
    stages = schedule.stages
    for st in stages:
        sl = layout.stage(st.idx)
        ch, bk = sl.home_channel, sl.home_bank

        # stage constants stream in once per round (load-save property)
        if st.const_bytes:
            instrs.append(PimInstr(
                "LOAD", st.idx, -1, ch, bk, nbytes=st.const_bytes,
                scope="load",
                cycles=arch.xfer_seconds(st.const_bytes, "load") * f))

        # spilled limbs: every execution of the stage reaches across
        # the bank boundary for them. Generation>0 limbs overflowed the
        # whole device: bill the off-chip round-trip (write back the
        # previous residents, stream these in) — the streaming regime
        # must not be free. (A degenerate arch bills neither: the flat
        # model has no layout semantics by definition, and its naive
        # overflow regime is already priced by reload_per_op loads.)
        if not arch.degenerate:
            stream_b = 2 * sl.streamed_bytes       # write-back + refill
            for nbytes, scope in ((sl.spill_bytes_bank, "bank"),
                                  (sl.spill_bytes_channel, "channel"),
                                  (stream_b, "load")):
                if nbytes:
                    instrs.append(PimInstr(
                        "XFER", st.idx, -1, ch, bk, nbytes=nbytes,
                        scope=scope,
                        cycles=arch.xfer_seconds(nbytes, scope) * f))

        for op in st.ops:
            c = op_cost(params, op)
            rows = c.modmuls + c.ks_modmuls
            if rows:
                weighted = c.modmuls + arch.ks_modmul_weight * c.ks_modmuls
                instrs.append(PimInstr(
                    "ROWOP", st.idx, op.idx, ch, bk, rows=rows,
                    cycles=arch.rows_seconds(weighted, n) * f,
                    op_kind=op.kind))
            if c.ntts:
                instrs.append(PimInstr(
                    "NTT", st.idx, op.idx, ch, bk, rows=c.ntts,
                    cycles=arch.rows_seconds(
                        c.ntts * arch.ntt_row_cost
                        * math.log2(max(n, 2)), n) * f,
                    op_kind=op.kind))
                shuffle_b = c.ntts * arch.ntt_shuffle_bytes(n)
                if shuffle_b:
                    instrs.append(PimInstr(
                        "XFER", st.idx, op.idx, ch, bk, nbytes=shuffle_b,
                        scope="intra",
                        cycles=arch.xfer_seconds(shuffle_b, "intra") * f,
                        op_kind=op.kind))
            if c.move_bytes:
                # ModUp/ModDown limb distribution stays bank-local; only
                # the automorphism's slot permutation (the ciphertext
                # itself, for rotate/conjugate) rides the inter-bank
                # permutation network
                perm_b = 0
                if op.kind in ("rotate", "conjugate"):
                    perm_b = min(c.move_bytes,
                                 ct_bytes(params, op.level
                                          if op.level is not None
                                          else params.n_levels))
                intra_b = c.move_bytes - perm_b
                if intra_b:
                    instrs.append(PimInstr(
                        "XFER", st.idx, op.idx, ch, bk, nbytes=intra_b,
                        scope="intra",
                        cycles=arch.xfer_seconds(intra_b, "intra") * f,
                        op_kind=op.kind))
                if perm_b:
                    instrs.append(PimInstr(
                        "XFER", st.idx, op.idx, ch, bk, nbytes=perm_b,
                        scope="bank",
                        cycles=arch.xfer_seconds(perm_b, "bank") * f,
                        op_kind=op.kind))

        # stage output hops to the next stage's bank
        if st.out_bytes:
            nxt = stages[st.idx + 1] if st.idx + 1 < len(stages) else st
            scope = arch.transfer_scope(st.partition, nxt.partition)
            if arch.degenerate:
                scope = "bank"     # the flat model's single transfer link
            instrs.append(PimInstr(
                "STORE", st.idx, -1, ch, bk, nbytes=st.out_bytes,
                scope=scope,
                cycles=arch.xfer_seconds(st.out_bytes, scope) * f))

    return PimProgram(arch.name, f, instrs, len(stages))


def program_movement_profile(prog: PimProgram,
                             arch: PimArch) -> List[dict]:
    """Static movement profile of a lowered stream: per interconnect
    scope, the total XFER+STORE bytes and the seconds the arch's peak
    link bandwidth would need for them — the lowering-time counterpart
    of the runtime telemetry's ``fhe_pim_move_bytes`` /
    ``fhe_pim_move_bw_frac`` series (fig22 reports both sides)."""
    by_scope = {}
    for stage in range(prog.n_stages):
        for scope, nbytes in prog.stage_scope_bytes(stage).items():
            by_scope[scope] = by_scope.get(scope, 0) + nbytes
    return [{"scope": scope, "bytes": nbytes,
             "peak_bw": arch.scope_bw(scope),
             "seconds_at_peak": nbytes / arch.scope_bw(scope)}
            for scope, nbytes in sorted(by_scope.items())]
