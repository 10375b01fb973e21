"""Roofline of each (arch x shape) cell on NVIDIA H100s.

The PyTorch counterpart of ``repro.launch.roofline``. The reference lowers
unrolled configs at depth knobs k = 1 and 2 and extrapolates to full
depth, because XLA's cost analysis does not multiply while-loop bodies by
their trip counts. The port counts eagerly (FlopCounterMode over the step
on meta tensors, `launch.dryrun`), which has no such blind spot, so it
counts the full-depth step directly; it also records the reference's
k = 1, 2 extrapolation beside it and the gap between the two.

Terms per cell on the 16x16 production mesh, in one H100 SXM's peaks
(NVIDIA H100 80GB HBM3 data sheet, dense, 700 W):
    compute_s    = flops_per_device / 989.4e12        bf16 dense
                   (the partitioned step's local matmuls, launch.dryrun,
                   plus the recurrence work below over n_devices; where
                   no partitioned step is counted, flops / n_devices)
    memory_s     = (argument + output bytes per device) / 3.35e12
                   the least traffic a step must move: each input read
                   once and each laid-out output written once (not XLA's
                   "bytes accessed", which the port cannot derive)
    collective_s = collective_total / 50e9
                   the partitioned step's collective result bytes per
                   device over one 400 Gb/s ConnectX-7 NDR port, the one
                   InfiniBand port a GPU has in a DGX H100. That link and
                   not NVLink's 450 GB/s a direction: an NVLink domain is
                   one node of 8 GPUs, and the 16x16 mesh's `model` axis
                   (16 ranks) is wider than a node, so every collective
                   along it crosses nodes, and one along `data` (or `pod`)
                   does anyway; a ring along `model` runs at the speed of
                   its slowest hop, the inter-node one
    MODEL_FLOPS  = 6 * N_active * tokens (train) / 2 * N_active * tokens
    useful ratio = MODEL_FLOPS / flops
    roofline fraction = (MODEL_FLOPS / (n_devices * peak)) / max(terms)
`dominant`, `bound_s` and the fraction cover the three terms.
`flops` is matmul_flops plus the recurrence work FlopCounterMode does not
see: RG-LRU's scan is elementwise, so the reference's analytic correction
is added for it (once: to the unsharded count, and over the devices to
the partitioned one, whose island counts only matmuls, so none of the
scan); RWKV6's state update goes through einsums the counter already
counts, so nothing is added (its elementwise decay is not counted, as no
elementwise work is).

`--measure` runs one real step of a cut cell (--layers, --batch, --seq) on
one device (CUDA unless --device cpu) and prints the median step time
against the bound, with the real step's FlopCounterMode count beside the
meta count and the spec-derived argument bytes beside the real tensors';
one device moves nothing between devices, so its collective_s is 0.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.roofline --arch qwen3-8b \\
        --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.roofline --arch qwen3-8b \\
        --shape train_4k --measure --layers 4 --batch 8 --seq 128
Records are appended to build/repro_torch/results/roofline.jsonl.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time
import traceback

import torch

from repro_torch.compat import abstract_mesh
from repro_torch.configs import DASHED, get_config
from repro_torch.core.context import resolve_device
from repro_torch.launch.dryrun import (RESULTS_DIR, count_matmul_flops,
                                       leaves, mesh_of, partitioned_counts,
                                       sharded_bytes)
from repro_torch.launch.specs import SHAPES, build_cell, cell_applicable
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.train.optim import adamw_init

PEAK_FLOPS = 989.4e12      # H100 SXM bf16 dense FLOP/s
HBM_BW = 3.35e12           # H100 SXM HBM3 bytes/s
LINK_BW = 50e9             # one 400 Gb/s ConnectX-7 NDR port, bytes/s

CANONICAL = [k for k in DASHED if "_" not in k]


def scaled_cfgs(arch: str, knob: int, cfg: ArchConfig = None):
    """Return [(tag, cfg, knob_units)] at this depth knob (of `cfg`, the
    arch's published config by default)."""
    cfg = cfg or get_config(arch)
    out = []
    if cfg.enc_dec:
        out.append(("encdec", dataclasses.replace(
            cfg, n_layers=knob, n_enc_layers=knob), knob))
    elif cfg.xattn_period:
        per = cfg.xattn_period + 1
        out.append(("superblock", dataclasses.replace(
            cfg, n_layers=per * knob), knob))
    elif cfg.rglru:
        per = len(cfg.block_pattern or ("rglru", "rglru", "attn"))
        out.append(("superblock", dataclasses.replace(
            cfg, n_layers=per * knob), knob))
    elif cfg.n_experts and cfg.first_k_dense:
        out.append(("moe", dataclasses.replace(
            cfg, n_layers=knob, first_k_dense=0), knob))
        out.append(("dense", dataclasses.replace(
            cfg, n_layers=knob, first_k_dense=0, n_experts=0,
            n_shared_experts=0, mtp=False), knob))
    else:
        out.append(("layer", dataclasses.replace(cfg, n_layers=knob), knob))
    return out


def full_knobs(arch: str, cfg: ArchConfig = None):
    """(units per tag) at full depth, matching scaled_cfgs tags."""
    cfg = cfg or get_config(arch)
    if cfg.enc_dec:
        return {"encdec": cfg.n_layers}
    if cfg.xattn_period:
        return {"superblock": cfg.n_layers // (cfg.xattn_period + 1)}
    if cfg.rglru:
        per = len(cfg.block_pattern or ("rglru", "rglru", "attn"))
        return {"superblock": cfg.n_layers / per}   # 26/3: tail ~ 2/3 sb
    if cfg.n_experts and cfg.first_k_dense:
        return {"moe": cfg.n_layers - cfg.first_k_dense,
                "dense": cfg.first_k_dense}
    return {"layer": cfg.n_layers}


def _tokens(shape: str) -> int:
    sh = SHAPES[shape]
    return sh["batch"] * (1 if sh["kind"] == "decode" else sh["seq"])


def _recurrence_total(cfg: ArchConfig, shape: str) -> float:
    """The reference's analytic FLOPs of the time-axis scans, over the
    whole step. RWKV6 state update: ~4 ops x H x dh x dh per token per
    layer; RG-LRU: ~8 ops x width per token per layer (2/3 of layers).
    Train counts fwd + bwd + remat-refwd (x4); inference x1."""
    factor = 4.0 if SHAPES[shape]["kind"] == "train" else 1.0
    tokens = _tokens(shape)
    if cfg.rwkv:
        h = cfg.d_model // 64
        return 4 * h * 64 * 64 * cfg.n_layers * tokens * factor
    if cfg.rglru:
        w = cfg.lru_width or cfg.d_model
        return 8 * w * (cfg.n_layers * 2 / 3) * tokens * factor
    return 0.0


def recurrence_correction(arch: str, shape: str) -> float:
    """The reference's correction: per device on the 16x16 mesh."""
    return _recurrence_total(get_config(arch), shape) / 256


def recurrence_added(cfg: ArchConfig, shape: str):
    """(FLOPs added to matmul_flops for recurrence work the counter does
    not see, what they are)."""
    if cfg.rglru:
        return _recurrence_total(cfg, shape), (
            "RG-LRU scan: the reference's 8 ops x width per token per "
            "recurrent layer (x4 in training), elementwise, unseen by "
            "FlopCounterMode")
    if cfg.rwkv:
        return 0.0, ("none: RWKV6's state update is two einsums a step, "
                     "counted by FlopCounterMode; its elementwise decay is "
                     "not counted, as no elementwise work is")
    return 0.0, "none: no time-axis scan"


def model_flops(arch: str, shape: str) -> float:
    cfg = get_config(arch)
    mult = 6.0 if SHAPES[shape]["kind"] == "train" else 2.0
    return mult * cfg.active_param_count() * _tokens(shape)


def extrapolate(arch: str, count, cfg: ArchConfig = None, k1: int = 1,
                k2: int = 2) -> float:
    """The reference's depth extrapolation of count(cfg) (a number for a
    depth-cut config) from knobs k1 and k2 to full depth: exact for a
    homogeneous stack."""
    fk = full_knobs(arch, cfg)
    total = 0.0
    for (tag, c1, u1), (_, c2, u2) in zip(scaled_cfgs(arch, k1, cfg),
                                          scaled_cfgs(arch, k2, cfg)):
        m1, m2 = count(c1), count(c2)
        slope = (m2 - m1) / (u2 - u1)
        base = m1 - slope * u1
        if tag == "dense":          # dense pair: slope only (outer terms
            total += slope * fk[tag]    # already in the moe pair)
        else:
            # depth-monotone floor: full depth >= the depth-k2 count
            total += max(base + slope * fk[tag], m2)
    return total


def terms_of(flops: float, arg_bytes: int, out_bytes, n_devices: int,
             mf: float, flops_per_device=None,
             collective_total=None) -> dict:
    """The roofline terms; dominant, bound and fraction over the non-null
    ones. compute_s takes flops_per_device where given (else flops over
    the devices); collective_s is collective_total over LINK_BW (None
    where not counted; 0 on one device)."""
    compute_s = (flops_per_device if flops_per_device is not None
                 else flops / n_devices) / PEAK_FLOPS
    memory_s = (arg_bytes + (out_bytes or 0)) / HBM_BW
    collective_s = (0.0 if n_devices == 1 else None
                    if collective_total is None
                    else collective_total / LINK_BW)
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    live = {k: v for k, v in terms.items() if v is not None}
    dom = max(live, key=live.get)
    return dict(terms, dominant=dom,
                bound_s=live[dom], model_flops=mf,
                useful_flops_ratio=mf / max(flops, 1.0),
                roofline_fraction=(mf / (n_devices * PEAK_FLOPS))
                / max(live.values()))


def run_cell(arch: str, shape: str, k1: int = 1, k2: int = 2,
             partition=None) -> dict:
    """One cell's roofline record. `partition` is partitioned_counts'
    result for it on 16x16 (counted here, in a process of its own, when
    not given)."""
    mesh = mesh_of(multi_pod=False)
    rec = {"arch": arch, "shape": shape, "mesh": "16x16",
           "n_devices": mesh.size}
    cfg = get_config(arch)
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    try:
        t0 = time.perf_counter()
        cell = build_cell(arch, shape, mesh)
        full = count_matmul_flops(cell)["matmul_flops"]

        def count(c):
            return count_matmul_flops(build_cell(
                arch, shape, mesh, cfg_override=c))["matmul_flops"]
        k12 = extrapolate(arch, count, k1=k1, k2=k2)
        added, what = recurrence_added(cfg, shape)
        flops = full + added
        arg_b = sharded_bytes(cell["args"], cell["in_specs"], mesh)
        out_b = (sharded_bytes(cell["outs"], cell["out_specs"], mesh)
                 if cell["outs"] is not None else None)
        if partition is None:
            partition = partitioned_counts([(arch, shape)], False).get(
                (arch, shape))
        if isinstance(partition, str):
            raise RuntimeError(f"partitioned count: {partition}")
        per_dev = partition["flops_per_device"] + added / mesh.size
        coll = partition["collective_total"]
        rec.update(
            status="ok", measure_s=round(time.perf_counter() - t0, 1),
            matmul_flops=full, matmul_flops_k12=k12,
            k12_gap=(k12 - full) / full,
            recurrence_added_flops=added, recurrence_added=what,
            flops=flops, argument_bytes=arg_b, output_bytes=out_b,
            memory_terms=["argument_bytes"] + (
                ["output_bytes"] if out_b is not None else []),
            flops_per_device=per_dev, collective_total=coll,
            collective_bytes=partition["collective_bytes"],
            partitioner="dtensor",
            **terms_of(flops, arg_b, out_b, mesh.size,
                       model_flops(arch, shape), per_dev, coll),
            absent={})
    except Exception as e:  # noqa: BLE001
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   tb=traceback.format_exc()[-1500:])
    return rec


def _materialize(cell, dev, seed: int = 0):
    """Real inputs on `dev` for a cell's meta args: seeded weights
    (models.init_params), a fresh AdamW state or zero cache, random tokens
    and bf16 inputs."""
    cfg = cell["cfg"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = M.init_params(cfg, gen, dev)

    def fill(t):
        if t.dtype == torch.int32:
            return torch.randint(0, cfg.vocab, t.shape, generator=gen,
                                 dtype=t.dtype, device=dev)
        return torch.randn(t.shape, generator=gen, dtype=t.dtype, device=dev)
    kind = cell["meta"]["kind"]
    args = cell["args"]
    if kind == "train":
        return (params, adamw_init(params), M.tree_map(fill, args[2]))
    if kind == "prefill":
        return (params, M.tree_map(fill, args[1]))
    b, s = cell["meta"]["batch"], cell["meta"]["seq"]
    return (params, M.init_cache(cfg, b, s, dev), fill(args[2]), args[3])


def measure(arch: str, shape: str, device=None, layers: int = None,
            batch: int = None, seq: int = None, smoke: bool = False,
            steps: int = 5, warmup: int = 1) -> dict:
    """One cut cell on one device: the meta count and the spec-derived
    bytes on a one-device mesh, then the same step on real tensors: one
    step under FlopCounterMode, `warmup` steps, and `steps` timed steps
    (each ending in a device barrier). The bound is the roofline's, on one
    device."""
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=smoke)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    mesh = abstract_mesh((1, 1), ("data", "model"))
    cell = build_cell(arch, shape, mesh, cfg_override=cfg, batch=batch,
                      seq=seq)
    if cell["skip"]:
        raise ValueError(f"{arch} {shape}: {cell['reason']}")
    meta = count_matmul_flops(cell)
    arg_b = sharded_bytes(cell["args"], cell["in_specs"], mesh)
    out_b = (sharded_bytes(cell["outs"], cell["out_specs"], mesh)
             if cell["outs"] is not None else None)
    added, what = recurrence_added(cfg, shape)
    kind = cell["meta"]["kind"]
    b, s = cell["meta"]["batch"], cell["meta"]["seq"]
    tokens = b * (1 if kind == "decode" else s)
    mf = (6.0 if kind == "train" else 2.0) * cfg.active_param_count() * tokens

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    sync()
    mem0 = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None
    args = _materialize(cell, dev)
    sync()
    mem_delta = (torch.cuda.memory_allocated(dev) - mem0
                 if dev.type == "cuda" else None)
    real_bytes = sum(4 if isinstance(x, int) else x.nbytes
                     for x in leaves(args))
    real = count_matmul_flops(dict(cell, args=args))
    del real["out"]
    times = []
    for i in range(warmup + steps):
        sync()
        t0 = time.perf_counter()
        out = cell["fn"](*args)
        sync()
        if i >= warmup:
            times.append(time.perf_counter() - t0)
        del out
    ms = statistics.median(times) * 1e3
    t = terms_of(meta["matmul_flops"] + added, arg_b, out_b, 1, mf)
    return {"arch": arch, "config": cfg.name, "shape": shape, "kind": kind,
            "n_layers": cfg.n_layers, "batch": b, "seq": s,
            "device": str(dev),
            "meta_matmul_flops": meta["matmul_flops"],
            "real_matmul_flops": real["matmul_flops"],
            "matmul_flops_by_op": meta["matmul_flops_by_op"],
            "recurrence_added_flops": added, "recurrence_added": what,
            "argument_bytes": arg_b, "output_bytes": out_b,
            "real_argument_bytes": real_bytes,
            "memory_allocated_delta": mem_delta,
            **t, "bound_ms": t["bound_s"] * 1e3,
            "ms_steps": [x * 1e3 for x in times], "ms": ms,
            "ratio": ms / (t["bound_s"] * 1e3),
            "warmup_steps": warmup, "timed_steps": steps}


def describe_measure(r: dict) -> str:
    return (f"measure {r['config']} {r['shape']} n_layers {r['n_layers']}, "
            f"batch {r['batch']} x seq {r['seq']} on {r['device']}: "
            f"{r['ms']:.3f} ms a step (median of {r['timed_steps']} after "
            f"{r['warmup_steps']} warm-up) against the bound "
            f"{r['bound_ms']:.3f} ms ({r['dominant']}; compute "
            f"{r['compute_s'] * 1e3:.3f} ms, memory "
            f"{r['memory_s'] * 1e3:.3f} ms): {r['ratio']:.2f}x; matmul "
            f"FLOPs meta {r['meta_matmul_flops']} / real "
            f"{r['real_matmul_flops']}; argument bytes from specs "
            f"{r['argument_bytes']} / real tensors "
            f"{r['real_argument_bytes']}"
            + (f" / memory_allocated delta {r['memory_allocated_delta']}"
               if r["memory_allocated_delta"] is not None else ""))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--out", default=None)
    ap.add_argument("--measure", action="store_true",
                    help="time one real step of a cut cell on one device")
    ap.add_argument("--device", default=None,
                    help="--measure's device (CUDA unless 'cpu')")
    ap.add_argument("--smoke", action="store_true",
                    help="--measure the arch's smoke config")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    args = ap.parse_args(argv)
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    out_path = args.out or str(RESULTS_DIR / "roofline.jsonl")
    if args.measure:
        if not (args.arch and args.shape):
            ap.error("--measure needs --arch and --shape")
        r = measure(args.arch, args.shape, args.device, args.layers,
                    args.batch, args.seq, args.smoke)
        with open(out_path, "a") as f:
            f.write(json.dumps(r) + "\n")
        print(describe_measure(r), flush=True)
        return 0 if r["real_matmul_flops"] == r["meta_matmul_flops"] else 1
    archs = [args.arch] if args.arch else CANONICAL
    shapes = [args.shape] if args.shape else list(SHAPES)
    n_err = 0
    parts = partitioned_counts([(a, s) for a in archs for s in shapes
                                if cell_applicable(get_config(a), s)[0]],
                               False)
    with open(out_path, "a") as f:
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, partition=parts.get((arch, shape)))
                f.write(json.dumps(rec) + "\n")
                f.flush()
                if rec["status"] == "ok":
                    coll = f"{rec['collective_s'] * 1e3:9.3f}ms"
                    print(f"[ok] {arch:24s} {shape:12s} "
                          f"comp={rec['compute_s'] * 1e3:9.3f}ms "
                          f"mem={rec['memory_s'] * 1e3:9.3f}ms "
                          f"coll={coll} "
                          f"dom={rec['dominant'][:-2]:8s} "
                          f"rf={rec['roofline_fraction']:.3f} "
                          f"k12_gap={rec['k12_gap']:+.2e}", flush=True)
                else:
                    n_err += rec["status"] == "error"
                    print(f"[{rec['status']}] {arch} {shape} "
                          f"{rec.get('error', rec.get('reason', ''))[:120]}",
                          flush=True)
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
