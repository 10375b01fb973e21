"""Multi-pod dry run on meta tensors.

The PyTorch counterpart of ``repro.launch.dryrun``. For every
(architecture x input shape) cell it lays the cell's inputs and outputs
out on the production mesh (single-pod 16x16 = 256 devices, multi-pod
2x16x16 = 512) and records what the port can derive without a device:

* `argument_bytes`, `output_bytes`: one device's share of the step's
  inputs and of the outputs that have specs, summed leaf by leaf over
  each leaf's block under its spec (every sharded dim divides evenly by
  construction);
* `matmul_flops`: what torch.utils.flop_counter.FlopCounterMode counts
  over the whole unsharded step run once on meta tensors (matmuls,
  convolutions and attention; no elementwise work, so it is not XLA's
  `flops`). A train step counts the forward, the backward and each
  checkpointed block's recompute (torch.utils.checkpoint, the reference's
  remat); the count is the same on both meshes and is made once.

The reference lowers and compiles each cell; the port has no compiler,
so the fields that come from one (memory and cost analysis, the HLO and
the collectives in it, lower and compile seconds) are null and the
record's `absent` key names each with its reason.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun            # everything
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --multi-pod  # 512 devices
Records are appended to build/repro_torch/results/dryrun.jsonl.
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path
from typing import Dict, Optional

from torch.utils.flop_counter import FlopCounterMode

from repro_torch.compat import abstract_mesh
from repro_torch.configs import DASHED, list_archs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import SHAPES, build_cell
from repro_torch.sharding.rules import shard_shape

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch" / \
    "results"
DEVICE_MEMORY_BYTES = 80 * 2 ** 30     # one H100 80GB
POS_BYTES = 4   # decode's position: the reference passes an int32 scalar

NO_COMPILER = "the port has no compiler"
ABSENT = {
    "flops_per_device": f"{NO_COMPILER}: no cost_analysis; matmul_flops "
                        "is FlopCounterMode's count of the whole step",
    "bytes_per_device": f"{NO_COMPILER}: no cost_analysis 'bytes "
                        "accessed'",
    "temp_bytes": f"{NO_COMPILER}: no memory_analysis; temporaries depend "
                  "on a compiled schedule",
    "collective_bytes": "no sharded step is executed or compiled, so no "
                        "collective is derived",
    "collective_total": "no sharded step is executed or compiled, so no "
                        "collective is derived",
    "lower_s": f"{NO_COMPILER}: nothing is lowered",
    "compile_s": f"{NO_COMPILER}: nothing is compiled",
    "hlo_chars": f"{NO_COMPILER}: no HLO",
}
COUNTED = {
    "train": "forward, backward and each checkpointed block's recompute "
             "of the whole batch (AdamW and the clip are elementwise)",
    "prefill": "the forward of the whole batch",
    "decode": "one decode step of the whole batch at pos = seq - 1",
}


def leaf_pairs(tree, specs):
    """(leaf, spec) pairs of a tree of tensors (dicts in sorted key order,
    tuples, lists) and the tree of specs that mirrors it."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_pairs(tree[k], specs[k])
    elif isinstance(tree, (tuple, list)):
        for t, s in zip(tree, specs, strict=True):
            yield from leaf_pairs(t, s)
    else:
        yield tree, specs


def leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k])
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            yield from leaves(t)
    else:
        yield tree


def sharded_bytes(tree, specs, mesh) -> int:
    """One device's bytes of `tree` laid out by `specs` on `mesh`."""
    total = 0
    for x, spec in leaf_pairs(tree, specs):
        if isinstance(x, int):
            total += POS_BYTES
            continue
        total += math.prod(shard_shape(mesh, spec, x.shape)) * \
            x.element_size()
    return total


def _same_layout(a, b) -> bool:
    """Two trees of tensors with the same structure, shapes and dtypes."""
    la, lb = list(leaves(a)), list(leaves(b))
    return len(la) == len(lb) and all(
        tuple(x.shape) == tuple(y.shape) and x.dtype == y.dtype
        for x, y in zip(la, lb))


def count_matmul_flops(cell) -> Dict:
    """Run the cell's step once under FlopCounterMode (on whatever device
    its args are: meta for the dry run). Returns matmul_flops, the count
    by op, the wall seconds and the outputs; where the cell lays its
    outputs out, they must have the shapes and dtypes of cell['outs']."""
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc:
        out = cell["fn"](*cell["args"])
    seconds = time.perf_counter() - t0
    if cell["outs"] is not None and not _same_layout(out, cell["outs"]):
        raise AssertionError(f"{cell['meta']}: the step's outputs differ "
                             f"from the cell's laid-out outputs")
    by_op = {str(op).split(".")[-1]: int(n)
             for op, n in fc.get_flop_counts().get("Global", {}).items()}
    return {"matmul_flops": int(fc.get_total_flops()),
            "matmul_flops_by_op": by_op, "count_s": seconds, "out": out}


def mesh_of(multi_pod: bool):
    shape, axes = make_production_mesh(multi_pod=multi_pod)
    return abstract_mesh(shape, axes)


def run_cell(arch: str, shape: str, multi_pod: bool, count: bool = True,
             counts: Optional[Dict] = None) -> dict:
    """One cell's record. `counts` caches (arch, shape) -> the count, so
    a second mesh reuses it; count=False leaves matmul_flops null."""
    mesh = mesh_of(multi_pod)
    rec = {"arch": arch, "shape": shape,
           "mesh": "x".join(str(v) for v in mesh.shape.values()),
           "n_devices": mesh.size}
    try:
        cell = build_cell(arch, shape, mesh)
        if cell["skip"]:
            rec.update(status="skipped", reason=cell["reason"])
            return rec
        meta = cell["meta"]
        arg_b = sharded_bytes(cell["args"], cell["in_specs"], mesh)
        out_b = (sharded_bytes(cell["outs"], cell["out_specs"], mesh)
                 if cell["outs"] is not None else None)
        absent = dict(ABSENT)
        if out_b is None:
            absent["output_bytes"] = ("the prefill step's outputs have no "
                                      "specs: the reference leaves their "
                                      "layout to its compiler")
        c = None
        if count:
            key = (arch, shape)
            c = counts.get(key) if counts is not None else None
            if c is None:
                c = count_matmul_flops(cell)
                c.pop("out")
                if counts is not None:
                    counts[key] = c
        else:
            absent["matmul_flops"] = "not counted in this run"
        fits = arg_b <= DEVICE_MEMORY_BYTES
        rec.update(
            status="ok", kind=meta["kind"], batch=meta["batch"],
            seq=meta["seq"],
            argument_bytes=arg_b, output_bytes=out_b,
            matmul_flops=c["matmul_flops"] if c else None,
            matmul_flops_by_op=c["matmul_flops_by_op"] if c else None,
            counted=COUNTED[meta["kind"]] if c else None,
            count_s=round(c["count_s"], 3) if c else None,
            fits_device=fits,
            **{k: None for k in ABSENT},
            absent=absent)
        if not fits:
            rec["note"] = (f"argument bytes per device exceed one H100's "
                           f"{DEVICE_MEMORY_BYTES / 2 ** 30:.0f} GiB: this "
                           f"layout does not fit the card")
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   tb=traceback.format_exc()[-2000:])
    return rec


def describe(rec: dict) -> str:
    tag = rec["status"]
    msg = f"[{tag:7s}] {rec['arch']:24s} {rec['shape']:12s} {rec['mesh']:8s}"
    if tag == "ok":
        msg += f" args/dev={rec['argument_bytes'] / 2 ** 30:8.2f} GiB"
        if rec["matmul_flops"] is not None:
            msg += (f" matmul={rec['matmul_flops'] / 1e12:12.1f} TFLOP "
                    f"(count {rec['count_s']:.1f} s)")
        if not rec["fits_device"]:
            msg += " [over 80 GiB]"
    elif tag == "error":
        msg += " " + rec["error"][:120]
    return msg


def canonical_archs():
    """The arch ids as the reference's dry run names them (dashed)."""
    return [next(k for k, v in DASHED.items() if v == a)
            for a in list_archs()]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    out_path = args.out or str(RESULTS_DIR / "dryrun.jsonl")
    archs = [args.arch] if args.arch else canonical_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    n_ok = n_skip = n_err = 0
    counts: Dict = {}
    with open(out_path, "a") as f:
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    rec = run_cell(arch, shape, mp, counts=counts)
                    f.write(json.dumps(rec) + "\n")
                    f.flush()
                    tag = rec["status"]
                    n_ok += tag == "ok"
                    n_skip += tag == "skipped"
                    n_err += tag == "error"
                    print(describe(rec), flush=True)
    print(f"done: ok={n_ok} skipped={n_skip} errors={n_err} -> {out_path}")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
