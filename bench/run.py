"""Benchmark of the PyTorch and CUDA port (`repro_torch`): one run of one
cell on the card it is started on.

    python3 bench/run.py --workload helr-paper.b8 --seed 7 --seconds 10 \\
        --trace 0

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted` and `failed` (ciphertexts), `metrics` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), `device`, with
``--trace 1`` a `breakdown`, and last `check`: each number compared
beside its limit, which also close standard error. Exits non-zero and
prints no result without a CUDA card, without the program beside it, or
when JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))
# caches at fixed paths inside the checkout, so later runs find them
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
    os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr)
    sys.exit(1)


def main(argv=None) -> None:
    args = parse(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("the program (src/repro_torch) is not beside the benchmark")
    import torch
    from bench import cells, harness

    cell = cells.cell(args.workload)
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if torch.cuda.device_count() < cell["chips"]:
        fail(f"{cell['chips']} cards needed, "
             f"{torch.cuda.device_count()} present")
    from repro_torch.kernels import build
    build.build()
    out = harness.execute(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda", t0=T_START)
    found = harness.forbidden_modules(sys.modules)
    if found:
        fail("loaded in this process: " + ", ".join(found))
    harness.report(out)


if __name__ == "__main__":
    main()
