"""Fig. 18 counterpart of the port (cost-model calibration): per-stage
predicted vs measured execution time for the serving workload sweep.

For each registered workload family the same compiled
`PipelineSchedule` is (a) priced stage-by-stage by the analytic model
(`stage_times`: load + max(compute, transfer), the AnalyticBackend
formula) and (b) executed stage-by-stage on actually encrypted batches
through the batched CKKS engine (repro_torch/compiler/engine.py) on one
device, with a device barrier ending each stage. The first two encrypted
runs warm the context's tables and the key and constant caches; the
third run's times are reported.

Absolute agreement is not expected (the MemoryModel prices a paper-scale
PIM device, the measurement is this device), so the table reports, per
workload, a single fitted scale factor (sum measured / sum predicted)
and the per-stage ratio spread around it, plus pairwise rank concordance
(do the backends agree which stages are the expensive ones?).

The same settings, workloads, seeds, records and gates as
``benchmarks/fig18_calibration.py``. The library route is a
`CiphertextBackend` built with ``use_kernels=False`` (the port's default
on CUDA is the kernels, so it is passed explicitly): every keyswitch and
plaintext product through torch ops (``core/ops.py``). With
``--use-kernels`` every workload also runs on a backend built with
``use_kernels=True``: K1-K3 (the fused keyswitch) on every hmul and
rotate and K4 in the engine's plaintext products, the hand-written CUDA
kernels on ``--device cuda`` (the default, which raises without a CUDA
device) and their plain versions on ``--device cpu``. Its decodes must be
bit-equal to the library route's on every workload. The kernel route's
stage times are recorded beside the library route's, and each route's
total record carries the kernel launches it made (CUDA launches only;
the library route must make none).

    PYTHONPATH=src python -m repro_torch.benchmarks.fig18_calibration \\
        [--smoke] [--use-kernels] [--device {cuda,cpu}]

Emits ``name,us_per_call,derived`` CSV rows (repro_torch.benchmarks.run
contract; the kernel route's rows end in ``_cuda`` or ``_plain``) and
rewrites ``build/repro_torch/results/fig18_calibration.jsonl`` for
report.py.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.benchmarks.common import row, write_records
from repro_torch.compiler import PassConfig
from repro_torch.compiler.interp import reference_eval
from repro_torch.core.context import resolve_device
from repro_torch.core.params import test_params
from repro_torch.core.pipeline import MemoryModel
from repro_torch.core.trace import trace_program
from repro_torch.kernels import common as kcom
from repro_torch.runtime.ciphertext_backend import CiphertextBackend
from repro_torch.runtime.compile_cache import CompileCache
from repro_torch.runtime.workloads import (HELR_CONSTS, LOLA_CONSTS,
                                           lola_infer, make_helr_iter,
                                           make_matvec, make_poly_eval,
                                           matvec_consts, poly_consts)


def _workloads(smoke: bool):
    dim = 8 if smoke else 16
    deg = 8 if smoke else 12
    return {
        "helr": (make_helr_iter(), 2, HELR_CONSTS),
        "lola": (lola_infer, 1, LOLA_CONSTS),
        f"matvec{dim}": (make_matvec(dim), 1, matvec_consts(dim)),
        f"poly{deg}": (make_poly_eval(deg), 1, poly_consts(deg)),
    }


def _setting(smoke: bool):
    # partitions sized to a few keyswitch footprints so every workload
    # splits into several stages — a one-row calibration table says
    # nothing about per-stage agreement
    if smoke:
        params = test_params(log_n=8, n_levels=8, dnum=2, log_scale=26)
        mem = MemoryModel(n_partitions=4, partition_bytes=256 * 2 ** 10)
        return params, mem, 7, 4
    params = test_params(log_n=10, n_levels=8, dnum=2, log_scale=26)
    mem = MemoryModel(n_partitions=4, partition_bytes=1 * 2 ** 20)
    return params, mem, 7, 8


def rank_concordance(a, b, tie_rel: float = 0.0) -> float:
    """Fraction of strictly-ordered pairs of `a` that `b` orders the
    same way (1.0 = identical stage ranking; 0.5 ~ uncorrelated).

    `tie_rel` drops pairs whose `a` values are within that relative
    margin: a 3.8us-vs-4.0us predicted pair is a coin flip for any
    measured route, so route-vs-route comparisons exclude it."""
    pairs = concordant = 0
    for i in range(len(a)):
        for j in range(i + 1, len(a)):
            if a[i] == a[j] or abs(a[i] - a[j]) <= tie_rel * max(a[i], a[j]):
                continue
            pairs += 1
            if (a[i] < a[j]) == (b[i] < b[j]):
                concordant += 1
    return concordant / pairs if pairs else 1.0


def _counted_runs(engine, sched, inputs, cvals, wname):
    """Three runs of the schedule (two warm-ups, then the measured one)
    and the kernel launches they made, by kernel."""
    before = {k: v.launches for k, v in kcom.KERNELS.items()}
    for _ in range(2):
        engine.run_schedule(sched, inputs, cvals, const_scope=(wname,))
    outs, measured = engine.run_schedule(sched, inputs, cvals,
                                         const_scope=(wname,))
    launches = {k: v.launches - before.get(k, 0)
                for k, v in kcom.KERNELS.items()}
    return outs, measured, launches


def main(argv=()) -> list:
    # argv defaults to () so run.py can call main() without
    # this parser swallowing run.py's own flags
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="small ring + workloads, fast CI check")
    ap.add_argument("--use-kernels", action="store_true",
                    help="also run every workload through the fused "
                         "kernel route (use_kernels=True), assert its "
                         "decodes are bit-equal to the library route and "
                         "its rank concordance is no worse")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the encrypted runs go: cuda (default; "
                         "raises without a CUDA device) runs the kernel "
                         "route on the hand-written kernels, cpu on their "
                         "plain versions")
    args = ap.parse_args(list(argv))
    dev = resolve_device(args.device)
    route = "cuda" if dev.type == "cuda" else "plain"

    params, mem, start, batch = _setting(args.smoke)
    backend = CiphertextBackend(params, use_kernels=False, device=dev)
    engine = backend.engine
    kbackend = (CiphertextBackend(params, use_kernels=True, device=dev)
                if args.use_kernels else None)
    kengine = kbackend.engine if kbackend is not None else None
    slots = params.slots
    cc = CompileCache()
    cfg = PassConfig(start_level=start, bsgs_min_terms=4)
    rng = np.random.default_rng(0)

    records = []
    conc_tracked = []
    for wname, (fn, n_in, consts) in _workloads(args.smoke).items():
        trace = trace_program(fn, n_in, const_names=consts)
        sched = cc.get_schedule(trace, params, mem, pass_config=cfg)
        predicted = [load + max(comp, xfer)
                     for load, comp, xfer in sched.stage_times(batch)]

        cvals = backend.workload_consts(wname, sched.trace)
        inputs = [rng.uniform(-0.8, 0.8, size=(batch, slots))
                  for _ in sched.trace.inputs]
        # runs 1 and 2 build the context's tables and fill the key and
        # constant caches; run 3 is the steady serving state this table
        # calibrates
        outs, measured, lib_launches = _counted_runs(engine, sched, inputs,
                                                     cvals, wname)
        assert not any(lib_launches.values()), (
            f"{wname}: the library route launched kernels "
            f"{lib_launches}")
        ref = reference_eval(sched.trace, inputs, cvals)
        err = max(float(np.abs(np.asarray(d) - np.asarray(r)).max())
                  for d, r in zip(outs, ref))

        # bootstrap stages are excluded from the fit: the engine refreshes
        # exactly (decrypt/re-encrypt) while the model bills the full
        # EvalMod chain — by design not the same operation
        boot = [any(o.kind == "bootstrap" for o in st.ops)
                for st in sched.stages]
        fit_pred = sum(p for p, b in zip(predicted, boot) if not b)
        fit_meas = sum(m for m, b in zip(measured, boot) if not b)
        scale = fit_meas / fit_pred if fit_pred else 0.0
        conc = rank_concordance(
            [p for p, b in zip(predicted, boot) if not b],
            [m for m, b in zip(measured, boot) if not b])
        for st, pred_s, meas_s, is_boot in zip(sched.stages, predicted,
                                               measured, boot):
            ratio = meas_s / (pred_s * scale) if pred_s and scale else 0.0
            row(f"fig18_{wname}_stage{st.idx}", meas_s * 1e6,
                f"pred={pred_s * 1e6:.1f}us x{ratio:.2f}"
                f"{' [bootstrap]' if is_boot else ''} {st.describe()}")
            records.append({
                "workload": wname, "stage": st.idx,
                "n_ops": len(st.ops), "bootstrap": is_boot,
                "predicted_s": pred_s, "measured_s": meas_s,
                "ratio_vs_fit": ratio, "smoke": bool(args.smoke),
            })
        row(f"fig18_{wname}_total", sum(measured) * 1e6,
            f"pred={sum(predicted) * 1e6:.1f}us scale={scale:.1f} "
            f"concordance={conc:.2f} maxerr={err:.2e}")
        records.append({
            "workload": wname, "stage": "total",
            "n_ops": sum(len(st.ops) for st in sched.stages),
            "predicted_s": sum(predicted), "measured_s": sum(measured),
            "fitted_scale": scale, "rank_concordance": conc,
            "max_decrypt_error": err, "tolerance": engine.tolerance,
            "smoke": bool(args.smoke),
            "use_kernels": backend.use_kernels, "launches": lib_launches,
        })

        if kengine is not None:
            # fused-kernel route on the identical schedule: same keys
            # (same ctor seed), so decodes must be BIT-equal, and the
            # stage ranking the analytic model is calibrated against
            # must not degrade. The equality assert runs on every
            # registered workload — it is the serving-level proof that
            # the fused keyswitch pipeline changes dispatch structure,
            # not arithmetic.
            kouts, kmeasured, k_launches = _counted_runs(
                kengine, sched, inputs, cvals, wname)
            for d_lib, d_ker in zip(outs, kouts):
                np.testing.assert_array_equal(np.asarray(d_lib),
                                              np.asarray(d_ker))
            fit_p = [p for p, b in zip(predicted, boot) if not b]
            kconc = rank_concordance(
                fit_p, [m for m, b in zip(kmeasured, boot) if not b])
            # concordance for the no-worse check is tie-tolerant: pairs
            # of stages predicted within 10% of each other are coin
            # flips for any measured route, so they carry no signal
            conc_tt = rank_concordance(
                fit_p, [m for m, b in zip(measured, boot) if not b],
                tie_rel=0.1)
            kconc_tt = rank_concordance(
                fit_p, [m for m, b in zip(kmeasured, boot) if not b],
                tie_rel=0.1)
            conc_tracked.append((wname, conc_tt, kconc_tt))
            for st, meas_s in zip(sched.stages, kmeasured):
                records.append({
                    "workload": wname, "stage": st.idx, "route": "kernels",
                    "measured_s": meas_s, "smoke": bool(args.smoke),
                })
            row(f"fig18_{wname}_kernels_total_{route}",
                sum(kmeasured) * 1e6,
                f"fused-kernel route; concordance={kconc:.2f} "
                f"(library {conc:.2f}); decode bit-equal")
            records.append({
                "workload": wname, "stage": "total", "route": "kernels",
                "measured_s": sum(kmeasured), "rank_concordance": kconc,
                "library_rank_concordance": conc, "bit_equal": True,
                "smoke": bool(args.smoke),
                "use_kernels": kbackend.use_kernels,
                "launches": k_launches,
            })

    if conc_tracked:
        # aggregate, not per-workload: on the CPU the kernel route runs
        # the kernels' plain versions, whose per-call torch overhead can
        # inflate one predicted-cheap stage in one workload; only the
        # card runs the kernels themselves. The mean over the workload
        # sweep is what the fig16/fig17 analytic sweeps rely on, and THAT
        # must not degrade.
        lib_mean = sum(c for _, c, _ in conc_tracked) / len(conc_tracked)
        ker_mean = sum(k for _, _, k in conc_tracked) / len(conc_tracked)
        row("fig18_kernels_concordance_mean", 0.0,
            f"kernels {ker_mean:.2f} vs library {lib_mean:.2f} "
            f"(tie-tolerant, asserted no worse) "
            + " ".join(f"{w}={k:.2f}/{c:.2f}"
                       for w, c, k in conc_tracked))
        assert ker_mean >= lib_mean - 0.2, (
            f"kernel-route rank concordance degraded: mean {ker_mean:.2f}"
            f" < library {lib_mean:.2f} - 0.2 ({conc_tracked})")
        records.append({
            "stage": "concordance_summary", "route": "kernels",
            "kernels_mean": ker_mean, "library_mean": lib_mean,
            "per_workload": [
                {"workload": w, "library": c, "kernels": k}
                for w, c, k in conc_tracked],
            "smoke": bool(args.smoke),
        })

    write_records("fig18_calibration.jsonl", records, dev)
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
