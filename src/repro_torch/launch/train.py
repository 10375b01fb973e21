"""Training driver: any zoo arch on one device (CUDA unless --device cpu),
with checkpoint/restart, straggler watch and deterministic replay.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
        --smoke --steps 100 --batch 8 --seq 128 [--device cpu]

The port of ``repro.launch.train``: the reference's flags plus --device,
and its printed lines (the arch line, a `step ... loss= ce= gnorm=` row
every --log-every steps and the `done:` line). Weights come from
init_params with a generator seeded 0 on the device; the batches are
SyntheticLMDataset's, the reference's numpy draws. The mesh is a process
group of world size 1 (nccl on CUDA, gloo on the CPU), started here
unless one is running and destroyed at the end if started here.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core.context import resolve_device
from repro_torch.data.pipeline import SyntheticLMDataset, shard_batch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault import Supervisor
from repro_torch.train.optim import adamw_init


@dataclasses.dataclass
class TrainResult:
    params: Dict[str, Any]
    opt_state: Dict[str, Any]
    history: List[Dict[str, float]]    # each step's metrics
    start: int                         # the step the run began at


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="torch device everything runs on; cuda fails "
                         "when no CUDA device is present")
    return ap.parse_args(argv)


def train(args: argparse.Namespace, mesh) -> TrainResult:
    device = mesh.device
    cfg = get_config(args.arch, smoke=args.smoke)
    print(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
          f"mesh={dict(mesh.shape)}")

    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device)
    opt_state = adamw_init(params)
    ds = SyntheticLMDataset(cfg, args.batch, args.seq)
    step_fn = M.make_train_step(cfg, mesh, learning_rate=args.lr)
    start = 0
    if args.resume:
        latest = ckpt.latest_step(args.ckpt_dir)
        if latest:
            tree, start = ckpt.restore_checkpoint(
                args.ckpt_dir, {"params": params, "opt": opt_state},
                device=device)
            params, opt_state = tree["params"], tree["opt"]
            print(f"resumed from step {start}")

    def make_batch(step):
        return shard_batch(ds.batch_at(step), device)

    sup = Supervisor(step_fn, args.ckpt_dir, ckpt_every=args.ckpt_every,
                     device=device)
    t0 = time.time()
    (params, opt_state), history = sup.run(
        (params, opt_state), make_batch, args.steps, start_step=start)
    dt = time.time() - t0
    for i, h in enumerate(history):
        if i % args.log_every == 0 or i == len(history) - 1:
            print(f"step {start + i:5d} loss={h['loss']:.4f} "
                  f"ce={h['ce']:.4f} gnorm={h['grad_norm']:.3f}")
    n = max(len(history), 1)
    toks = args.batch * args.seq * n
    print(f"done: {n} steps in {dt:.1f}s "
          f"({toks / dt:.0f} tok/s); events={sup.events}")
    return TrainResult(params, opt_state, history, start)


def main(argv: Optional[List[str]] = None) -> TrainResult:
    args = parse_args(argv)
    device = resolve_device(args.device)
    started = not dist.is_initialized()
    mesh = make_host_mesh(device=device)
    try:
        return train(args, mesh)
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
