"""Hierarchical FHEmem hardware model (paper §III-IV): channels → banks
→ subarrays → mats, with a bit-serial long-bitwidth modmul cycle model
and scope-dependent data-movement bandwidths.

The flat 16-partition `MemoryModel` in core/pipeline.py is the
*degenerate case* of this hierarchy: `PimArch.to_memory_model()`
projects an arch onto the flat model (banks become partitions, the
bank-level lane throughput becomes `modmul_throughput`, the
inter-bank permutation network becomes `transfer_bw`), and the
``flat`` preset round-trips to the MemoryModel defaults exactly — the
regression `tests/test_pim.py` pins. The analytic serving backend and
the PIM discrete-event backend therefore share ONE preset registry
(`serve_fhe --mem-profile`, `benchmarks/common.mem_profile`): no
duplicated magic constants.

Three presets:

* ``fhemem`` — the paper's configuration: many banks of bit-serial
  subarray/mat compute (one element per bit-line column, a w-bit
  modmul costs O(w²) row activations) joined by an inter-bank
  permutation network for NTT/rotation data movement.
* ``hbm2`` — an HBM2-PIM-like point (Aquabolt-XL style): wide SIMD
  units near the bank IO (no bit-serial in-mat compute), weaker
  per-bank throughput, and no permutation network — inter-bank data
  rides the channel bus.
* ``flat`` — the degenerate preset reproducing `MemoryModel()`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

from repro_torch.core.pipeline import MemoryModel

WORD = 8   # stored bytes per coefficient (core/trace.py WORD)

# data-movement scopes, innermost to outermost
SCOPES = ("intra", "bank", "channel", "load")


@dataclasses.dataclass(frozen=True)
class PimArch:
    """One FHEmem hardware point. Frozen so archs can key caches."""
    name: str
    # -- hierarchy geometry --------------------------------------------------
    n_channels: int = 8
    banks_per_channel: int = 16
    subarrays_per_bank: int = 64
    mats_per_subarray: int = 32
    mat_rows: int = 512                  # DRAM rows per mat
    mat_cols: int = 2048                 # bit-line columns = bit-serial lanes
    # -- timing --------------------------------------------------------------
    freq_hz: float = 1e9                 # internal command clock
    t_row_cycles: float = 2.0            # activate+precharge per row command
    limb_bits: int = 32                  # coefficient bitwidth (word32 mode)
    add_cycles: float = 1.0              # cycles per bit-serial add step
    mod_hamming_weight: int = 3          # Solinas popcount h: reduction adds
    # -- bandwidths (bytes/s) ------------------------------------------------
    load_bw: float = 64e9                # off-chip constants into a bank
    intra_bank_bw: float = 2e12          # subarray<->subarray row copies
    #                                      (LISA-style full-row moves: the
    #                                      movement PIM makes nearly free)
    inter_bank_bw: float = 1e12          # permutation network, banks/channel
    #                                      (per-bank links, far above the
    #                                      shared-bus 256e9 the flat model
    #                                      assumes — the paper's §IV-C/D
    #                                      NTT/rotation movement fabric)
    inter_channel_bw: float = 512e9      # across channels (TSV bundles)
    # -- cost-model knobs (shared with MemoryModel) --------------------------
    ntt_row_cost: float = 1.0
    ks_modmul_weight: float = 1.25
    # NTT butterfly passes shuffle operands between mats (the paper's
    # vertical/horizontal inter-mat phases); billed per pass against
    # intra_bank_bw when True (hierarchy presets) — the flat/wide
    # presets keep the MemoryModel convention of compute-only NTTs
    ntt_inter_mat_shuffle: bool = False
    # degenerate override: bill modmul rows at this flat elementwise
    # throughput (elements/s per bank) instead of the bit-serial model
    flat_modmul_throughput: Optional[float] = None
    # degenerate archs bill EXACTLY like the flat MemoryModel: one
    # transfer link, no layout-scope distinctions, no spill traffic —
    # the regression anchor tying the PIM backend to the analytic one
    degenerate: bool = False

    # -- derived geometry ----------------------------------------------------

    @property
    def n_banks(self) -> int:
        return self.n_channels * self.banks_per_channel

    @property
    def mat_bytes(self) -> int:
        return self.mat_rows * self.mat_cols // 8

    @property
    def subarray_bytes(self) -> int:
        return self.mats_per_subarray * self.mat_bytes

    @property
    def bank_bytes(self) -> int:
        return self.subarrays_per_bank * self.subarray_bytes

    @property
    def total_bytes(self) -> int:
        return self.n_banks * self.bank_bytes

    @property
    def lanes_per_bank(self) -> int:
        """Bit-serial lanes: one element per bit-line column."""
        return (self.subarrays_per_bank * self.mats_per_subarray
                * self.mat_cols)

    # -- cycle model ---------------------------------------------------------

    def modmul_cycles(self, bits: Optional[int] = None) -> float:
        """Cycles for ONE bit-serial modular multiply in a lane: w
        shift-add partial products of w bits each, h·w reduction adds
        (Solinas fold, paper §IV-B), plus row activate/precharge for
        streaming the three w-bit operands through the sense amps."""
        w = bits if bits is not None else self.limb_bits
        return (w * (w + self.mod_hamming_weight) * self.add_cycles
                + 3 * w * self.t_row_cycles)

    def rows_seconds(self, row_equiv: float, n: int) -> float:
        """Seconds for `row_equiv` N-element modmul-row equivalents on
        one bank. Bit-serial hierarchy: the bank's lanes chew
        ``lanes_per_bank`` elements per wave of `modmul_cycles()`, so
        many rows of a small ring run concurrently (limb-parallel
        modmul — the layout spreads limbs across subarrays for exactly
        this). Degenerate/wide presets bill the flat throughput."""
        if self.flat_modmul_throughput is not None:
            return row_equiv * n / self.flat_modmul_throughput
        waves = math.ceil(row_equiv * n / self.lanes_per_bank)
        return waves * self.modmul_cycles() / self.freq_hz

    def modmul_row_seconds(self, n: int) -> float:
        """Seconds for one N-element modmul row on one bank."""
        return self.rows_seconds(1, n)

    def ntt_pass_seconds(self, n: int) -> float:
        """One full N-point NTT pass over one limb (butterfly compute
        only; the inter-mat shuffle traffic is a separate XFER the
        lowerer emits when ``ntt_inter_mat_shuffle``)."""
        return self.rows_seconds(
            self.ntt_row_cost * math.log2(max(n, 2)), n)

    def ntt_shuffle_bytes(self, n: int) -> int:
        """Bytes one NTT pass moves between mats: butterfly strides
        wider than a mat's column count reposition the full limb (the
        paper's vertical/horizontal inter-mat phases); smaller strides
        stay inside the mat's sense amps and move nothing."""
        if not self.ntt_inter_mat_shuffle:
            return 0
        stages_crossing = max(0, int(math.log2(max(n, 2)))
                              - int(math.log2(self.mat_cols)))
        return stages_crossing * n * WORD

    def scope_bw(self, scope: str) -> float:
        """Bytes/s available to a transfer of the given scope."""
        return {"intra": self.intra_bank_bw,
                "bank": self.inter_bank_bw,
                "channel": self.inter_channel_bw,
                "load": self.load_bw}[scope]

    def xfer_seconds(self, nbytes: int, scope: str) -> float:
        return nbytes / self.scope_bw(scope) if nbytes else 0.0

    def bank_coords(self, partition: int) -> tuple:
        """(channel, bank-in-channel) of a pipeline partition (stages
        are homed round-robin over the global bank space)."""
        g = partition % self.n_banks
        return g // self.banks_per_channel, g % self.banks_per_channel

    def transfer_scope(self, partition_a: int, partition_b: int) -> str:
        """Scope of a ciphertext hop between two partitions' banks."""
        ca, ba = self.bank_coords(partition_a)
        cb, bb = self.bank_coords(partition_b)
        if (ca, ba) == (cb, bb):
            return "intra"
        return "bank" if ca == cb else "channel"

    # -- flat-model adapter --------------------------------------------------

    def elems_per_second(self) -> float:
        """Aggregate elementwise modmul throughput of ONE bank."""
        if self.flat_modmul_throughput is not None:
            return self.flat_modmul_throughput
        return self.lanes_per_bank * self.freq_hz / self.modmul_cycles()

    def to_memory_model(self) -> MemoryModel:
        """Project the hierarchy onto the flat MemoryModel: banks are
        partitions, bank lane throughput is `modmul_throughput`, the
        permutation network is `transfer_bw`. The analytic backend and
        the mapper consume this; the PIM backend consumes the arch —
        one registry, two fidelities."""
        return MemoryModel(
            n_partitions=self.n_banks,
            partition_bytes=self.bank_bytes,
            load_bw=self.load_bw,
            modmul_throughput=self.elems_per_second(),
            ntt_row_cost=self.ntt_row_cost,
            transfer_bw=self.inter_bank_bw,
            ks_modmul_weight=self.ks_modmul_weight)


# ---------------------------------------------------------------------------
# presets
# ---------------------------------------------------------------------------

# the paper's FHEmem point: 128 banks of bit-serial subarray compute
# (~4M lanes/bank, 256 MiB banks) + inter-bank permutation network
FHEMEM = PimArch(name="fhemem", ntt_inter_mat_shuffle=True)

# HBM2-PIM-like (Aquabolt-XL): wide SIMD units at the bank IO, so far
# fewer "lanes" than in-mat bit-serial; no permutation network —
# inter-bank traffic rides the (much slower) channel bus. 8 GiB device.
HBM2 = PimArch(
    name="hbm2",
    n_channels=8, banks_per_channel=16,
    subarrays_per_bank=32, mats_per_subarray=32,
    mat_rows=512, mat_cols=1024,          # 64 MiB banks
    freq_hz=1.2e9,
    load_bw=32e9,
    intra_bank_bw=128e9,
    inter_bank_bw=25.6e9,                 # pseudo-channel bus
    inter_channel_bw=25.6e9,
    flat_modmul_throughput=1.5e11)        # wide units, not bit-serial

# degenerate preset == MemoryModel() defaults: 16 banks x 64 MiB,
# 2e12 elems/s, one 256e9 transfer scope, compute-only NTTs
FLAT = PimArch(
    name="flat",
    n_channels=4, banks_per_channel=4,
    subarrays_per_bank=16, mats_per_subarray=16,
    mat_rows=512, mat_cols=4096,          # 64 MiB banks
    freq_hz=1e9,
    load_bw=64e9,
    intra_bank_bw=256e9,
    inter_bank_bw=256e9,
    inter_channel_bw=256e9,
    flat_modmul_throughput=2.0e12,
    degenerate=True)

PRESETS: Dict[str, PimArch] = {a.name: a for a in (FHEMEM, HBM2, FLAT)}


def get_arch(name: str) -> PimArch:
    try:
        return PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown pim preset {name!r} "
                         f"(expected one of {sorted(PRESETS)})") from None


def memory_model(name: str) -> MemoryModel:
    """The shared preset registry's flat-model side: what `serve_fhe
    --mem-profile` and `benchmarks.common.mem_profile` hand to the
    analytic backend / pipeline mapper."""
    return get_arch(name).to_memory_model()


def flat_arch_from_memory_model(mem: MemoryModel,
                                name: str = "flat-custom") -> PimArch:
    """Wrap an arbitrary flat MemoryModel in a degenerate arch billing
    EXACTLY like it (the adapter direction the PIM backend uses when
    handed a mem that matches no preset, e.g. the serving smoke's tiny
    4-partition model). Geometry is synthesized to tile the partition
    capacity; all transfer scopes collapse to `transfer_bw`."""
    subarrays, mats, rows = 16, 16, 512
    cols = max(8, mem.partition_bytes * 8 // (subarrays * mats * rows))
    return PimArch(
        name=name,
        n_channels=1, banks_per_channel=mem.n_partitions,
        subarrays_per_bank=subarrays, mats_per_subarray=mats,
        mat_rows=rows, mat_cols=cols,
        freq_hz=1e9,
        load_bw=mem.load_bw,
        intra_bank_bw=mem.transfer_bw,
        inter_bank_bw=mem.transfer_bw,
        inter_channel_bw=mem.transfer_bw,
        ntt_row_cost=mem.ntt_row_cost,
        ks_modmul_weight=mem.ks_modmul_weight,
        flat_modmul_throughput=mem.modmul_throughput,
        degenerate=True)


def arch_for_memory_model(mem: MemoryModel) -> PimArch:
    """Recover the arch a MemoryModel came from: a preset whose
    projection equals `mem`, else a degenerate wrap of `mem`."""
    for arch in PRESETS.values():
        if arch.to_memory_model() == mem:
            return arch
    return flat_arch_from_memory_model(mem)
