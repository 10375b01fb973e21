"""Load-save pipeline mapping (§IV-F): stage splitting + round-robin
placement + latency/throughput estimation.

The paper's insight: a naive n-partition pipeline forces each partition to
hold the constants (evk, plaintext weights) of a coarse program slice; when
they don't fit, every op reloads its constants. The load-save pipeline
instead splits the program into *fine-grained* stages whose constants DO
fit, assigns them round-robin across partitions, and runs a whole batch of
inputs through each *round* of resident stages — constants stream in once
per round, not once per op.

The same mapper drives (a) the analytic benchmarks (fig15 ablation: naive
vs load-save), and (b) the real distributed executor
(repro/fhe_dist/pipeline_exec.py), where partitions are devices/device
groups on the mesh instead of memory banks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

from repro_torch.core.params import CkksParams
from repro_torch.core.trace import FheOp, FheTrace, OpCost, op_cost


@dataclasses.dataclass
class MemoryModel:
    """Abstract partitioned memory/compute (banks in the paper, device
    groups on a TPU mesh here).

    This flat model is the degenerate case of the hierarchical FHEmem
    model in ``repro/pim/arch.py``: ``PimArch.to_memory_model()`` derives
    these rates from channel/bank/subarray geometry, and the pim
    presets' flat member reproduces these defaults exactly.
    """
    n_partitions: int = 16
    partition_bytes: int = 64 * 2 ** 20      # capacity per partition
    load_bw: float = 64e9                    # bytes/s constants into a partition
    modmul_throughput: float = 2.0e12        # N-coeff modmul rows/s equivalent
    ntt_row_cost: float = 1.0                # relative NTT pass cost vs modmul row
    transfer_bw: float = 256e9               # inter-partition bytes/s
    ks_modmul_weight: float = 1.25           # digit-decomposition modmul rows
    #                                          read gathered (non-resident)
    #                                          operands: billed heavier than
    #                                          plain rows

    def compute_seconds(self, c: OpCost, n: int) -> float:
        """Seconds of partition-local work for one op: modmul rows (plain
        + weighted keyswitch digit-decomposition rows) + NTT butterfly
        passes + the op's own inter-partition data movement (rotation
        permutations, ModUp/ModDown limb distribution) — previously the
        last two channels were folded into plain modmul rows."""
        rows = (c.modmuls + self.ks_modmul_weight * c.ks_modmuls
                + self.ntt_row_cost * c.ntts * math.log2(max(n, 2)))
        return (rows * n / self.modmul_throughput
                + c.move_bytes / self.transfer_bw)


@dataclasses.dataclass
class Stage:
    idx: int
    ops: List[FheOp]
    partition: int = -1
    const_bytes: int = 0
    compute_s: float = 0.0
    out_bytes: int = 0

    def describe(self) -> str:
        kinds = {}
        for o in self.ops:
            kinds[o.kind] = kinds.get(o.kind, 0) + 1
        return f"stage{self.idx}@p{self.partition} " + \
            ",".join(f"{k}x{v}" for k, v in sorted(kinds.items()))


@dataclasses.dataclass
class PipelineSchedule:
    stages: List[Stage]
    rounds: List[List[Stage]]
    params: CkksParams
    mem: MemoryModel
    reload_per_op: bool = False   # naive mode: constants reloaded per op
    trace: Optional[FheTrace] = None  # the mapped trace (op objects are
    #                                   shared with the stages), so real
    #                                   executors can encrypt inputs and
    #                                   decode outputs (engine.run_schedule)
    pass_report: object = dataclasses.field(
        default=None, repr=False, compare=False)
    #   repro.compiler.PassReport from the optimizing compile that
    #   produced `trace` (None when serving verbatim) — attached by
    #   CompileCache so compile spans and fig17 can surface per-pass
    #   wall time without recompiling

    # -- latency model -------------------------------------------------------

    def stage_times(self, batch: int) -> List[Tuple[float, float, float]]:
        """(load_s, compute_s, transfer_s) per stage for a batch."""
        out = []
        for st in self.stages:
            if self.reload_per_op:
                load = batch * st.const_bytes / self.mem.load_bw
            else:
                load = st.const_bytes / self.mem.load_bw   # once per round
            compute = batch * st.compute_s
            transfer = batch * st.out_bytes / self.mem.transfer_bw
            out.append((load, compute, transfer))
        return out

    def bottleneck_latency(self, batch: int) -> float:
        """Paper metric: time per input when the pipeline is full = max
        stage time / batch (§V-C 'maximum time across all pipeline stages')."""
        times = self.stage_times(batch)
        worst = max(l + max(c, t) for (l, c, t) in times)
        return worst / batch

    def total_latency(self, batch: int) -> float:
        """End-to-end: rounds are sequential; within a round stages overlap
        (pipelined), so a round costs its worst stage + fill."""
        times = self.stage_times(batch)
        total = 0.0
        i = 0
        for rnd in self.rounds:
            rt = [times[st.idx] for st in rnd]
            worst = max(l + max(c, t) for (l, c, t) in rt)
            fill = sum(max(c, t) / batch for (l, c, t) in rt)
            total += worst + fill
            i += len(rnd)
        return total

    def loads_bytes(self) -> int:
        per_stage = [st.const_bytes for st in self.stages]
        if self.reload_per_op:
            return sum(p * 1 for p in per_stage)  # scaled by batch at use site
        return sum(per_stage)


# ---------------------------------------------------------------------------
# mappers
# ---------------------------------------------------------------------------

def _stage_cost(params: CkksParams, mem: MemoryModel,
                ops: List[FheOp]) -> Tuple[int, float, int]:
    const_b, comp, out_b = 0, 0.0, 0
    for o in ops:
        c = op_cost(params, o)
        const_b += c.const_bytes
        comp += mem.compute_seconds(c, params.n)
        out_b = c.out_bytes
    return const_b, comp, out_b


def generate_load_save_pipeline(trace: FheTrace, params: CkksParams,
                                mem: MemoryModel,
                                const_budget_frac: float = 0.5
                                ) -> PipelineSchedule:
    """The paper's mapper: fine-grained stages sized so each stage's
    constants fit in `const_budget_frac` of a partition; stages assigned
    round-robin; rounds of n_partitions stages."""
    budget = int(mem.partition_bytes * const_budget_frac)
    stages: List[Stage] = []
    cur: List[FheOp] = []
    cur_const = 0
    # evk is shared by all hmul/rotate ops in a stage — count once
    def flush():
        nonlocal cur, cur_const
        if cur:
            const_b, comp, out_b = _stage_cost(params, mem, cur)
            # shared-evk correction: count evk once per stage
            from repro_torch.core.trace import evk_bytes
            n_ks = sum(1 for o in cur if o.kind in ("hmul", "rotate", "conjugate"))
            if n_ks > 1:
                const_b -= (n_ks - 1) * evk_bytes(params)
            stages.append(Stage(len(stages), cur, -1, const_b, comp, out_b))
            cur, cur_const = [], 0

    for op in trace.compute_ops():
        c = op_cost(params, op)
        inc = c.const_bytes if op.kind not in ("hmul", "rotate", "conjugate") \
            or not any(o.kind in ("hmul", "rotate", "conjugate") for o in cur) \
            else 0
        if cur and cur_const + inc > budget:
            flush()
        cur.append(op)
        cur_const += inc
    flush()
    for i, st in enumerate(stages):
        st.partition = i % mem.n_partitions
    rounds = [stages[i:i + mem.n_partitions]
              for i in range(0, len(stages), mem.n_partitions)]
    return PipelineSchedule(stages, rounds, params, mem, reload_per_op=False,
                            trace=trace)


def generate_naive_pipeline(trace: FheTrace, params: CkksParams,
                            mem: MemoryModel) -> PipelineSchedule:
    """Base2-style mapper: split into exactly n_partitions coarse stages.
    Stages whose constants overflow the partition reload them per input."""
    ops = trace.compute_ops()
    n = mem.n_partitions
    per = math.ceil(len(ops) / n)
    stages = []
    overflow = False
    for i in range(0, len(ops), per):
        chunk = ops[i:i + per]
        const_b, comp, out_b = _stage_cost(params, mem, chunk)
        st = Stage(len(stages), chunk, len(stages) % n, const_b, comp, out_b)
        if const_b > mem.partition_bytes:
            overflow = True
        stages.append(st)
    return PipelineSchedule(stages, [stages], params, mem,
                            reload_per_op=overflow, trace=trace)
