"""Benchmark harness of the port: one module per paper table/figure, the
counterpart of ``benchmarks/run.py`` (the same twelve modules, with the
port's ``fig14_kernels`` in fig14's place).

Prints ``name,us_per_call,derived`` CSV rows. ``--device`` goes to the
drivers that place tensors (fig12, fig13, fig14, fig15, fig18, fig21,
fig22); the others run analytic or discrete-event models on the host.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--only fig12] \\
        [--device {cuda,cpu}]
"""
from __future__ import annotations

import argparse
import importlib

MODULES = ["fig1_bandwidth", "fig12_workloads", "fig13_breakdown",
           "fig14_kernels", "fig15_ablations", "fig16_serving",
           "fig17_compiler", "fig18_calibration", "fig19_pim",
           "fig20_fleet", "fig21_trace", "fig22_utilization"]
# the drivers that take --device
ON_DEVICE = {"fig12_workloads", "fig13_breakdown", "fig14_kernels",
             "fig15_ablations", "fig18_calibration", "fig21_trace",
             "fig22_utilization"}


def selected(only=None):
    """The modules `--only` picks: every one whose name contains it."""
    return [m for m in MODULES if not only or only in m]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--only", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="passed to the drivers that place tensors (cuda, "
                         "the default, raises without a CUDA device)")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    for m in selected(args.only):
        mod = importlib.import_module(f"repro_torch.benchmarks.{m}")
        print(f"# --- {m} ---")
        mod.main(["--device", args.device] if m in ON_DEVICE else [])


if __name__ == "__main__":
    main()
