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

and, from the partitioned step (`partitioner: "dtensor"`), run once on
meta tensors on the production mesh of 256 or 512 ranks over a fake
process group (`launch.mesh.fake_production_mesh`, in a process of its
own: the fake group must be the default one) under `StepCounter`:

* `collective_bytes`: one device's result bytes of each collective, by
  the reference's kind names (all-reduce, all-gather, reduce-scatter,
  all-to-all, collective-permute): DTensor's redistributions and the
  islands' collectives. These are what DTensor's propagation and the
  port's islands place, not XLA's: the two partitioners choose their
  own collectives, and the reference counts a scanned layer's body once
  in its HLO text, where this count runs every layer;
  `collective_total` their sum;
* `flops_per_device`: the matmul FLOPs of the ops one rank runs on its
  local blocks (FlopCounterMode's formulas), forward, backward and
  recompute as `matmul_flops`.

Two loops run folded on meta tensors, so every arch's counts take
seconds. The recurrent stacks' time loops (rwkv6-3b, recurrentgemma-2b)
run as one step batched over T, which counts what the T steps count
(`models.recurrent`), not the 2090-2769 s of a loop over T.
llama-3.2-vision-90b's image cross attention runs as one chunk of its
1601 tokens, not F6's 1601 one-token chunks (930 s a train count
unsharded): that count is the fold's, which includes the p.v product of
each cross-attention layer and pass, 2 * B * Hq * Sq * 1601 * dh, where
the loop's left it out (`models.layers.cross_attention`).

The reference lowers and compiles each cell; the port has no compiler,
so the fields that come from one (memory and cost analysis but the
collectives, lower and compile seconds, the HLO) are null and the
record's `absent` key names each with its reason.

Usage (each mesh's partitioned counts run in a process of their own,
which starts and destroys its fake process group):
    PYTHONPATH=src python -m repro_torch.launch.dryrun            # everything
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --multi-pod  # 512 devices
Records are appended to build/repro_torch/results/dryrun.jsonl.
"""
from __future__ import annotations

import argparse
import json
import math
import multiprocessing
import time
import traceback
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.compat import abstract_mesh
from repro_torch.configs import DASHED, list_archs
from repro_torch.launch.mesh import fake_production_mesh, make_production_mesh
from repro_torch.launch.specs import SHAPES, build_cell
from repro_torch.sharding.rules import shard_shape

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch" / \
    "results"
DEVICE_MEMORY_BYTES = 80 * 2 ** 30     # one H100 80GB
POS_BYTES = 4   # decode's position: the reference passes an int32 scalar

NO_COMPILER = "the port has no compiler"
ABSENT = {
    "bytes_per_device": f"{NO_COMPILER}: no cost_analysis 'bytes "
                        "accessed'",
    "temp_bytes": f"{NO_COMPILER}: no memory_analysis; temporaries depend "
                  "on a compiled schedule",
    "lower_s": f"{NO_COMPILER}: nothing is lowered",
    "compile_s": f"{NO_COMPILER}: nothing is compiled",
    "hlo_chars": f"{NO_COMPILER}: no HLO",
}
PARTITIONED = ("flops_per_device", "collective_bytes", "collective_total")
PARTITIONER = "dtensor"

COUNTED = {
    "train": "forward, backward and each checkpointed block's recompute "
             "of the whole batch (AdamW and the clip are elementwise)",
    "prefill": "the forward of the whole batch",
    "decode": "one decode step of the whole batch at pos = seq - 1",
}


# collectives by the reference's HLO kind names. The functional ones are
# DTensor's redistributions (their result is the op's output); the c10d
# ones are the Mesh's and the islands' own (in place: their result is
# the first argument: the output tensors, or the tensors reduced in
# place). send is counted at its recv, as a collective-permute's result
# is the received buffer.
COLLECTIVE_KINDS = {
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_dtensor.shard_dim_alltoall": "all-to-all",
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.alltoall_": "all-to-all",
    "c10d.recv_": "collective-permute",
    "c10d.broadcast_": "broadcast",
}
# communication ops that are no collective of their own
NOT_COLLECTIVE = {"_c10d_functional.wait_tensor",
                  "_c10d_functional._wrap_tensor_autograd",
                  "c10d.send", "c10d.barrier", "c10d.monitored_barrier_"}
COMM_NAMESPACES = ("_c10d_functional", "c10d", "_dtensor")


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


class StepCounter(TorchDispatchMode):
    """Counts, on one rank, what a (partitioned) step runs on that rank's
    own tensors: the result bytes of each collective by kind
    (`collective_bytes`, the reference's per-device HLO count) and the
    matmul FLOPs of the local ops (`flops`, FlopCounterMode's formulas).

    An op on DTensors is handed back to DTensor (NotImplemented), which
    runs it on the local blocks: those ops, its redistributions' functional
    collectives and the islands' c10d collectives come back here. The
    global-shape op DTensor runs on fake tensors to propagate shapes is
    not counted."""

    def __init__(self):
        super().__init__()
        self.collective_bytes: Dict[str, int] = {}
        self.collective_calls: Dict[str, int] = {}
        self.bytes_by_op: Dict[str, int] = {}      # the same, by op name
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor) for t in _tensors(list(args))):
            return out
        ns = func.namespace
        if ns in COMM_NAMESPACES:
            name = f"{ns}.{func._opname}"
            if name not in NOT_COLLECTIVE:
                kind = COLLECTIVE_KINDS.get(name, name)
                nb = _nbytes(args[0] if ns == "c10d" else out)
                self.collective_bytes[kind] = \
                    self.collective_bytes.get(kind, 0) + nb
                self.collective_calls[kind] = \
                    self.collective_calls.get(kind, 0) + 1
                self.bytes_by_op[name] = self.bytes_by_op.get(name, 0) + nb
            return out
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        return out


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


def count_partitioned(cell) -> Dict:
    """Run a partitioned cell's step once under StepCounter (on the rank
    this process is): collective_bytes by kind, collective_total,
    flops_per_device, the calls by kind and the wall seconds."""
    t0 = time.perf_counter()
    with StepCounter() as c:
        out = cell["fn"](*cell["args"])
    del out
    return {"collective_bytes": dict(sorted(c.collective_bytes.items())),
            "collective_total": sum(c.collective_bytes.values()),
            "collective_calls": dict(sorted(c.collective_calls.items())),
            "flops_per_device": c.flops,
            "partition_s": time.perf_counter() - t0}


def _count_cells(cells, multi_pod: bool) -> Dict:
    """In this process: a fake group of the production mesh's size, every
    (arch, shape) of `cells` built on it and counted; an error is kept
    as a string. The group is destroyed on return."""
    out = {}
    with fake_production_mesh(multi_pod=multi_pod) as mesh:
        for arch, shape in cells:
            try:
                cell = build_cell(arch, shape, mesh)
                out[(arch, shape)] = (None if cell["skip"]
                                      else count_partitioned(cell))
            except Exception as e:  # noqa: BLE001 — kept in the record
                out[(arch, shape)] = (f"{type(e).__name__}: {e}\n"
                                      f"{traceback.format_exc()[-1500:]}")
    return out


def _count_cells_to(conn, cells, multi_pod: bool) -> None:
    try:
        conn.send(_count_cells(cells, multi_pod))
    except BaseException as e:  # noqa: BLE001 — handed to the parent
        conn.send(f"{type(e).__name__}: {e}\n{traceback.format_exc()}")
    finally:
        conn.close()


class PartitionedCount:
    """partitioned_counts' work for one mesh in a spawned process of its
    own (the fake group must be that process's default group), started
    at construction: `result()` waits for it, `stop()` ends the process
    whether it finished or not."""

    def __init__(self, cells, multi_pod: bool):
        ctx = multiprocessing.get_context("spawn")
        self._conn, child = ctx.Pipe(duplex=False)
        self._proc = ctx.Process(target=_count_cells_to,
                                 args=(child, list(cells), multi_pod),
                                 daemon=True)
        self._proc.start()
        child.close()

    def result(self) -> Dict:
        try:
            out = self._conn.recv()
        except EOFError:
            self._proc.join()
            raise RuntimeError(f"the partitioned count's process ended "
                               f"with code {self._proc.exitcode}")
        finally:
            self.stop()
        if isinstance(out, str):
            raise RuntimeError(f"the partitioned count failed: {out}")
        return out

    def stop(self) -> None:
        if self._proc.is_alive():
            self._proc.terminate()
        self._proc.join()
        self._conn.close()


def partitioned_counts(cells: Iterable[Tuple[str, str]], multi_pod: bool
                       ) -> Dict:
    """(arch, shape) -> count_partitioned's dict (or an error string) for
    each cell, made in a process of its own."""
    cells = list(cells)
    if not cells:
        return {}
    return PartitionedCount(cells, multi_pod).result()


def mesh_of(multi_pod: bool):
    shape, axes = make_production_mesh(multi_pod=multi_pod)
    return abstract_mesh(shape, axes)


def run_cell(arch: str, shape: str, multi_pod: bool, count: bool = True,
             counts: Optional[Dict] = None,
             partition: Optional[Dict] = None) -> dict:
    """One cell's record. `counts` caches (arch, shape) -> the count, so
    a second mesh reuses it; count=False leaves matmul_flops null.
    `partition` holds partitioned_counts' results on this mesh; without
    it (or without this cell in it) the per-device fields are null."""
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
        part = (partition or {}).get((arch, shape))
        if isinstance(part, str):
            raise RuntimeError(f"partitioned count: {part}")
        if part is None:
            absent.update({k: "the partitioned step was not counted in "
                              "this run" for k in PARTITIONED})
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
            partitioner=PARTITIONER,
            flops_per_device=part["flops_per_device"] if part else None,
            collective_bytes=part["collective_bytes"] if part else None,
            collective_total=part["collective_total"] if part else None,
            collective_calls=part["collective_calls"] if part else None,
            partition_s=round(part["partition_s"], 3) if part else None,
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
        if rec["flops_per_device"] is not None:
            msg += (f" flops/dev={rec['flops_per_device']:.3e} "
                    f"coll={rec['collective_total'] / 2 ** 20:.1f}MiB "
                    f"({rec['partition_s']:.1f} s)")
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
    cells = [(a, s) for a in archs for s in shapes]
    parts = {mp: partitioned_counts(cells, mp) for mp in meshes}
    with open(out_path, "a") as f:
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    rec = run_cell(arch, shape, mp, counts=counts,
                                   partition=parts[mp])
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
