"""Hierarchical FHEmem hardware model: arch presets, data layout,
bank-level ISA + lowering, and the discrete-event `PimBackend`.

The paper's headline contribution is the hardware — channels → banks →
subarrays → mats doing bit-serial long-bitwidth modmuls in place, plus
an inter-bank permutation network for NTT/rotation movement. This
package models that hierarchy explicitly and plugs it into the serving
runtime as a fourth execution backend (`serve_fhe --backend pim`):

* ``arch``    parameterized hierarchy + cycle model; presets
              ``fhemem`` / ``hbm2`` / ``flat`` (degenerate =
              core/pipeline.MemoryModel), shared with the analytic
              side via ``memory_model(name)`` — one preset registry
* ``layout``  ciphertext limbs → subarrays under capacity, with
              spill accounting (the movement the paper optimizes)
* ``isa``     LOAD/ROWOP/NTT/XFER/STORE instruction stream with
              fractional-cycle accounting
* ``lower``   PipelineSchedule → instruction stream
* ``backend`` discrete-event executor satisfying the runtime backend
              contract; flat preset reproduces AnalyticBackend ≤1%

See DESIGN.md §10.
"""
from repro_torch.pim.arch import (FHEMEM, FLAT, HBM2, PRESETS, PimArch,
                                  arch_for_memory_model,
                                  flat_arch_from_memory_model, get_arch,
                                  memory_model)
from repro_torch.pim.backend import PimBackend, resolve_pim_backend
from repro_torch.pim.isa import PimInstr, PimProgram
from repro_torch.pim.layout import (LayoutError, LayoutPlan, Placement,
                                    StageLayout, plan_layout)
from repro_torch.pim.lower import lower_schedule

__all__ = [
    "PimArch", "PRESETS", "FHEMEM", "HBM2", "FLAT",
    "get_arch", "memory_model", "arch_for_memory_model",
    "flat_arch_from_memory_model",
    "Placement", "StageLayout", "LayoutPlan", "LayoutError", "plan_layout",
    "PimInstr", "PimProgram", "lower_schedule",
    "PimBackend", "resolve_pim_backend",
]
