"""Readings the limits of `correct` are set from, on the card: the
numbers compared for many seeds of the program as configured, of the
control (the program at the configuration's `control_ckks`, the nearest
lower precision: a smaller scale), and of the planted faults.

    python3 bench/control.py --workload helr-paper.b8 --seconds 2 \\
        --seeds 11 12 13 [--control] [--fault unchanged]

One process runs every seed, one after the other, each with its own
set-up, window and check; one JSON line a seed. The benchmark's own runs
(bench/run.py) never run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import contextlib

    from bench import cells, faults, harness
    cell = cells.cell(args.workload)
    if args.device == "cuda":
        from repro_torch.kernels import build
        build.build()
    over = cell["config"]["control_ckks"] if args.control else None
    for seed in args.seeds:
        ctx = (faults.FAULTS[args.fault]() if args.fault
               else contextlib.nullcontext())
        t = time.perf_counter()
        with ctx:
            out = harness.execute(cell, seed, args.seconds, False,
                                  args.device, ckks_override=over)
        row = {"workload": args.workload, "seed": seed,
               "control": args.control, "fault": args.fault,
               "correct": out["correct"], "wall_s": time.perf_counter() - t,
               "batches": out["extra"]["record"]["batches"],
               "readings": out["extra"]["readings"],
               "check_s": out["extra"]["check_s"]}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
