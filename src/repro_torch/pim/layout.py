"""Data-layout mapper: ciphertext limbs of each PipelineSchedule stage
→ subarrays of the stage's home bank, under per-subarray capacity.

The load-save mapper (core/pipeline.py) decides WHICH bank (partition)
a stage lives on; this module decides WHERE IN the bank its data
lives. Each compute op's output ciphertext is 2·(level+1) limb rows of
N coefficients; limbs are spread round-robin across the home bank's
subarrays — the layout that makes modmul limb-parallel (every limb's
row op runs in its own subarray simultaneously) and that the paper's
NTT/rotation phases permute between. A stage whose working set
overflows its home bank spills whole limbs to the following banks
(same channel first), and the lowerer bills the spilled bytes as
inter-bank traffic every time the stage runs.

Stages of one pipeline *round* are resident simultaneously, so
capacity is tracked per round: stage i and stage i+n_partitions share
a home bank but never coexist, exactly like the mapper's round
semantics. A round whose working set exceeds the whole device (the
naive mapper's reload-per-op regime) streams: placement continues in
a fresh residency *generation* (Placement.generation), earlier
generations having been written back.

Invariants (property-tested in tests/test_pim.py): every (op, poly,
limb) is placed exactly once; no subarray's bytes within one
(round, generation) exceed ``arch.subarray_bytes``; planning is
deterministic.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Tuple

from repro_torch.core.pipeline import PipelineSchedule, Stage
from repro_torch.pim.arch import WORD, PimArch


class LayoutError(Exception):
    """A single limb is larger than every subarray — unplaceable."""


@dataclasses.dataclass(frozen=True)
class Placement:
    """One ciphertext limb row pinned to one subarray."""
    op_idx: int          # trace op producing the ciphertext
    poly: int            # 0 = b component, 1 = a component
    limb: int            # RNS limb index
    channel: int
    bank: int            # bank within the channel
    subarray: int
    nbytes: int
    generation: int = 0  # residency generation: a round whose working
    #                      set exceeds the device streams — earlier
    #                      generations are written back before later
    #                      ones load (the naive/reload regime). Capacity
    #                      holds per (generation, subarray).


@dataclasses.dataclass
class StageLayout:
    stage_idx: int
    home_channel: int
    home_bank: int
    placements: List[Placement]
    spill_bytes_bank: int = 0      # limbs homed on other banks, same channel
    spill_bytes_channel: int = 0   # limbs pushed across channels

    @property
    def total_bytes(self) -> int:
        return sum(p.nbytes for p in self.placements)

    @property
    def streamed_bytes(self) -> int:
        """Bytes placed after a device flush (generation > 0): the
        round wrote earlier residents back and re-streamed these, so
        the lowerer bills them as off-chip round-trips."""
        return sum(p.nbytes for p in self.placements if p.generation > 0)


@dataclasses.dataclass
class LayoutPlan:
    arch: PimArch
    stages: List[StageLayout]

    def stage(self, idx: int) -> StageLayout:
        return self.stages[idx]


def _bank_order(arch: PimArch, home_channel: int,
                home_bank: int) -> Iterator[Tuple[int, int]]:
    """Deterministic candidate banks: home first, then the rest of the
    home channel, then the other channels round-robin."""
    for b in range(arch.banks_per_channel):
        yield home_channel, (home_bank + b) % arch.banks_per_channel
    for c in range(1, arch.n_channels):
        ch = (home_channel + c) % arch.n_channels
        for b in range(arch.banks_per_channel):
            yield ch, (home_bank + b) % arch.banks_per_channel


def _stage_limbs(stage: Stage, n: int) -> Iterator[Tuple[int, int, int, int]]:
    """(op_idx, poly, limb, nbytes) for every limb row the stage's
    output ciphertexts occupy (level-annotated ops; unannotated ops
    contribute nothing — they never reach a mapped schedule)."""
    limb_b = n * WORD
    for op in stage.ops:
        if op.level is None:
            continue
        for poly in (0, 1):
            for limb in range(op.level + 1):
                yield op.idx, poly, limb, limb_b


def plan_layout(schedule: PipelineSchedule, arch: PimArch) -> LayoutPlan:
    """Place every stage's limbs. Pure function of (schedule, arch)."""
    n = schedule.params.n
    out: List[StageLayout] = [None] * len(schedule.stages)  # type: ignore
    for rnd in schedule.rounds:
        # per-round residency: (channel, bank, subarray) -> used bytes
        used: Dict[Tuple[int, int, int], int] = {}
        gen = 0
        for st in rnd:
            ch, bk = arch.bank_coords(st.partition)
            sl = StageLayout(st.idx, ch, bk, [])
            rr = 0  # round-robin subarray cursor, per stage
            for op_idx, poly, limb, nbytes in _stage_limbs(st, n):
                if nbytes > arch.subarray_bytes:
                    raise LayoutError(
                        f"limb of {nbytes} bytes exceeds a subarray "
                        f"({arch.name}: {arch.subarray_bytes} bytes)")
                while True:
                    placed = False
                    for c, b in _bank_order(arch, ch, bk):
                        # probe the bank's subarrays from the cursor
                        for probe in range(arch.subarrays_per_bank):
                            s = (rr + probe) % arch.subarrays_per_bank
                            key = (c, b, s)
                            if used.get(key, 0) + nbytes \
                                    <= arch.subarray_bytes:
                                used[key] = used.get(key, 0) + nbytes
                                sl.placements.append(Placement(
                                    op_idx, poly, limb, c, b, s, nbytes,
                                    generation=gen))
                                rr = (s + 1) % arch.subarrays_per_bank
                                if (c, b) != (ch, bk):
                                    if c == ch:
                                        sl.spill_bytes_bank += nbytes
                                    else:
                                        sl.spill_bytes_channel += nbytes
                                placed = True
                                break
                        if placed:
                            break
                    if placed:
                        break
                    # device exhausted: the round streams — retire the
                    # current residency generation and start the next
                    gen += 1
                    used = {}
            out[st.idx] = sl
    return LayoutPlan(arch, out)
