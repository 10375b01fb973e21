"""Bank-level PIM instruction set with per-instruction cycle accounting.

Five opcodes cover everything the hierarchy executes:

* ``LOAD``  — stream a stage's constants (evk / plaintexts) off-chip
              into its home bank (once per pipeline round).
* ``ROWOP`` — N-element modular-multiply rows in the bank's bit-serial
              lanes. ``rows`` is the raw row count (plain + keyswitch
              digit-decomposition rows); the ``ks_modmul_weight``
              surcharge on the latter lands in ``cycles`` only.
* ``NTT``   — butterfly passes of an (i)NTT over resident limbs.
* ``XFER``  — op-internal data movement: rotation slot permutations
              over the inter-bank network, ModUp/ModDown limb
              distribution, NTT inter-mat shuffles, spilled-limb
              traffic. ``scope`` names the link it rides.
* ``STORE`` — the stage's output ciphertext hopping to the next
              stage's bank.

``cycles`` is fractional (float) on the arch's internal clock: the
model prices sub-cycle work exactly rather than rounding per
instruction, so summing a stream reproduces the analytic model to
float precision (the flat-preset regression depends on this).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

OPCODES = ("LOAD", "ROWOP", "NTT", "XFER", "STORE")


@dataclasses.dataclass(frozen=True)
class PimInstr:
    opcode: str
    stage: int
    op_idx: int          # trace op index; -1 for stage-level instructions
    channel: int
    bank: int
    rows: int = 0        # N-element rows (ROWOP) / NTT passes (NTT)
    nbytes: int = 0      # bytes streamed (LOAD) or moved (XFER/STORE)
    scope: str = ""      # intra|bank|channel|load for XFER/STORE/LOAD
    cycles: float = 0.0
    op_kind: str = ""    # source trace-op kind ("mul", "rotate", ...);
    #                      observability only — deliberately NOT in
    #                      to_jsonable, so the pim_streams goldens are
    #                      insensitive to it

    def to_jsonable(self) -> dict:
        d = {"opcode": self.opcode, "stage": self.stage,
             "op": self.op_idx, "channel": self.channel, "bank": self.bank,
             # cycles rounded so goldens are insensitive to float repr
             "cycles": round(self.cycles, 4)}
        if self.rows:
            d["rows"] = self.rows
        if self.nbytes:
            d["nbytes"] = self.nbytes
        if self.scope:
            d["scope"] = self.scope
        return d


@dataclasses.dataclass
class PimProgram:
    """A lowered PipelineSchedule: the flat instruction stream plus the
    per-stage second buckets the discrete-event backend consumes."""
    arch_name: str
    freq_hz: float
    instrs: List[PimInstr]
    n_stages: int
    # per-stage (load, comp, move, out) cycle buckets, built once — the
    # serving loop reads them per batch, so it must not rescan the
    # stream every time (instrs are immutable after lowering)
    _buckets: List[List[float]] = dataclasses.field(
        default=None, repr=False, compare=False)

    def __len__(self) -> int:
        return len(self.instrs)

    def total_cycles(self) -> float:
        return sum(i.cycles for i in self.instrs)

    def stage_instrs(self, stage: int) -> List[PimInstr]:
        return [i for i in self.instrs if i.stage == stage]

    _BUCKET = {"LOAD": 0, "ROWOP": 1, "NTT": 1, "XFER": 2, "STORE": 3}

    def stage_seconds(self, stage: int) -> Tuple[float, float, float, float]:
        """(load_s, compute_s, move_s, out_s) for one batch element:
        LOAD | ROWOP+NTT | XFER | STORE cycle sums over freq."""
        if self._buckets is None:
            buckets = [[0.0] * 4 for _ in range(self.n_stages)]
            for i in self.instrs:
                buckets[i.stage][self._BUCKET[i.opcode]] += i.cycles
            self._buckets = buckets
        f = self.freq_hz
        load, comp, move, out = self._buckets[stage]
        return load / f, comp / f, move / f, out / f

    def stage_class_cycles(self, stage: int) -> Dict[str, float]:
        """Per instruction-class cycle totals for one stage
        ({opcode: cycles}, every opcode present) — the PIM backend
        attributes execute spans down to these."""
        self._class_index()
        return dict(self._by_class[stage])

    def stage_bank_cycles(self, stage: int) -> Dict[int, float]:
        """Per-bank cycle totals for one stage ({bank: cycles})."""
        self._class_index()
        return dict(self._by_bank[stage])

    def stage_scope_bytes(self, stage: int) -> Dict[str, int]:
        """Bytes MOVED per interconnect scope in one stage — XFER plus
        STORE traffic ({scope: bytes}; constant LOAD streaming is a
        separate phenomenon and deliberately excluded). This is the
        movement side of the telemetry's bandwidth series: bytes here
        over the round's wall time, normalized by `PimArch.scope_bw`,
        is the link's utilization fraction."""
        if getattr(self, "_by_scope", None) is None:
            by_scope: List[Dict[str, int]] = [
                {} for _ in range(self.n_stages)]
            for i in self.instrs:
                if i.opcode in ("XFER", "STORE") and i.nbytes:
                    d = by_scope[i.stage]
                    d[i.scope] = d.get(i.scope, 0) + i.nbytes
            self._by_scope = by_scope
        return dict(self._by_scope[stage])

    def _class_index(self) -> None:
        if getattr(self, "_by_class", None) is None:
            by_class = [{op: 0.0 for op in OPCODES}
                        for _ in range(self.n_stages)]
            by_bank: List[Dict[int, float]] = [
                {} for _ in range(self.n_stages)]
            for i in self.instrs:
                by_class[i.stage][i.opcode] += i.cycles
                bb = by_bank[i.stage]
                bb[i.bank] = bb.get(i.bank, 0.0) + i.cycles
            self._by_class = by_class
            self._by_bank = by_bank

    def summary(self) -> Dict[str, float]:
        by_op: Dict[str, int] = {}
        cyc: Dict[str, float] = {}
        for i in self.instrs:
            by_op[i.opcode] = by_op.get(i.opcode, 0) + 1
            cyc[i.opcode] = cyc.get(i.opcode, 0.0) + i.cycles
        return {"n_instrs": len(self.instrs),
                "total_cycles": self.total_cycles(),
                **{f"n_{k.lower()}": v for k, v in sorted(by_op.items())},
                **{f"cycles_{k.lower()}": round(v, 4)
                   for k, v in sorted(cyc.items())}}

    def to_jsonable(self) -> dict:
        return {"arch": self.arch_name, "freq_hz": self.freq_hz,
                "n_stages": self.n_stages,
                "summary": self.summary(),
                "instrs": [i.to_jsonable() for i in self.instrs]}
