"""Fig. 19 counterpart of the port (PIM hierarchy model): FHEmem-preset vs
flat-model latency per workload, with a compute / movement / load
breakdown per pipeline stage.

Every workload in the serving registry is compiled once per hardware
point (the schedule is mapped against that point's projected
MemoryModel — partition count and capacity differ per preset) and
executed through the PIM discrete-event backend (repro_torch.pim.backend):
the schedule is lowered to a bank-level instruction stream and
replayed on a virtual clock. Three hardware points from the shared
preset registry (repro_torch.pim.arch):

* ``flat``   — the degenerate preset; reproduces AnalyticBackend
               stage times, so it doubles as the model-consistency
               check this benchmark asserts (≤1 % divergence).
* ``fhemem`` — the paper's hierarchy: bit-serial in-mat modmuls +
               inter-bank permutation network.
* ``hbm2``   — an HBM2-PIM-like point (wide near-bank units, channel
               bus instead of a permutation network).

The per-stage breakdown separates ROWOP/NTT cycles (compute), XFER +
STORE cycles (movement: rotations, ModUp/ModDown distribution, NTT
inter-mat shuffles, spills, inter-stage hops), and LOAD cycles
(constant streaming) — the decomposition the paper's §V analysis
hangs on: movement and load, not raw compute, dominate PIM-FHE.

The same settings, presets, records and gate as
``benchmarks/fig19_pim.py``. A discrete-event model: places no tensor.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig19_pim [--smoke]

Emits ``name,us_per_call,derived`` CSV rows (repro_torch.benchmarks.run
contract) and rewrites ``build/repro_torch/results/fig19_pim.jsonl`` for
report.py.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.benchmarks.common import HOST, pim_arch, row, write_records
from repro_torch.compiler import PassConfig
from repro_torch.core.params import paper_params_bootstrap, test_params
from repro_torch.core.trace import trace_program
from repro_torch.pim.backend import PimBackend
from repro_torch.runtime.batcher import Batch
from repro_torch.runtime.compile_cache import CompileCache
from repro_torch.runtime.executor import AnalyticBackend
from repro_torch.runtime.metrics import MetricsRegistry
from repro_torch.runtime.workloads import (HELR_CONSTS, LOLA_CONSTS,
                                           lola_infer, make_helr_iter,
                                           make_matvec, make_poly_eval,
                                           matvec_consts, poly_consts)

ARCHS = ("flat", "fhemem", "hbm2")


def _workloads(smoke: bool):
    dim = 8 if smoke else 16
    deg = 8 if smoke else 12
    rots = (1, 2, 4) if smoke else (1, 2, 4, 8, 16, 32, 64, 128)
    return {
        "helr": (make_helr_iter(rots), 2, HELR_CONSTS),
        "lola": (lola_infer, 1, LOLA_CONSTS),
        f"matvec{dim}": (make_matvec(dim), 1, matvec_consts(dim)),
        f"poly{deg}": (make_poly_eval(deg), 1, poly_consts(deg)),
    }


def _setting(smoke: bool):
    if smoke:
        return test_params(log_n=10, n_levels=8, dnum=2), 7, 4
    return paper_params_bootstrap(), 20, 8


def _execute(arch_name, sched, batch_n, workload):
    backend = PimBackend(arch=pim_arch(arch_name))
    mem = backend.arch.to_memory_model()
    batch = Batch(workload, [], [[] for _ in range(batch_n)], 0.0)
    total = backend.execute(sched, batch, key_cache=None,
                            metrics=MetricsRegistry(mem.n_partitions),
                            workload=workload)
    return total, backend.last_breakdown[workload]


def main(argv=()) -> list:
    # argv defaults to () so run.py can call main() without
    # this parser swallowing run.py's own flags
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="small ring + workloads, fast CI check")
    args = ap.parse_args(list(argv))

    params, start, batch_n = _setting(args.smoke)
    cc = CompileCache()
    cfg = PassConfig(start_level=start, bsgs_min_terms=4)

    records = []
    for wname, (fn, n_in, consts) in _workloads(args.smoke).items():
        trace = trace_program(fn, n_in, const_names=consts)
        totals = {}
        for arch_name in ARCHS:
            mem = pim_arch(arch_name).to_memory_model()
            sched = cc.get_schedule(trace, params, mem, pass_config=cfg)
            total, breakdown = _execute(arch_name, sched, batch_n, wname)
            totals[arch_name] = total
            comp = sum(e["compute_s"] for e in breakdown)
            move = sum(e["move_s"] for e in breakdown)
            load = sum(e["load_s"] for e in breakdown)
            busy = comp + move + load or 1.0

            if arch_name == "flat":
                # model-consistency gate: the degenerate preset must
                # reproduce the analytic backend it claims to subsume
                an = AnalyticBackend(mem)
                ref = an.execute(
                    sched, Batch(wname, [], [[] for _ in range(batch_n)],
                                 0.0),
                    key_cache=None,
                    metrics=MetricsRegistry(mem.n_partitions),
                    workload=wname)
                drift = abs(total - ref) / max(ref, 1e-30)
                assert drift <= 0.01, (
                    f"{wname}: flat pim backend drifted {drift:.2%} "
                    f"from AnalyticBackend")

            for e in breakdown:
                records.append({
                    "workload": wname, "arch": arch_name,
                    "stage": e["stage"], "partition": e["partition"],
                    "load_s": e["load_s"], "compute_s": e["compute_s"],
                    "move_s": e["move_s"], "busy_s": e["busy_s"],
                    "smoke": bool(args.smoke),
                })
            records.append({
                "workload": wname, "arch": arch_name, "stage": "total",
                "n_stages": len(sched.stages),
                "latency_s": total, "compute_s": comp, "move_s": move,
                "load_s": load,
                "compute_frac": comp / busy, "move_frac": move / busy,
                "load_frac": load / busy,
                "speedup_vs_flat": (totals["flat"] / total
                                    if "flat" in totals and total else 1.0),
                "smoke": bool(args.smoke),
            })
            row(f"fig19_{wname}_{arch_name}", total * 1e6,
                f"{len(sched.stages)}st compute={comp/busy*100:.0f}% "
                f"move={move/busy*100:.0f}% load={load/busy*100:.0f}% "
                f"speedup_vs_flat={totals['flat']/total:.2f}x")

    write_records("fig19_pim.jsonl", records, HOST)
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
