"""End-to-end LM pretraining driver on the port: ~100M-param dense
transformer, a few hundred steps, with checkpoint/restart + straggler
supervision. The counterpart of ``examples/lm_pretrain.py``: the same
configs, flags (plus --device), printed lines and final assertion.

Defaults are CPU-sized (~27M params, 200 steps); pass --full for the
~115M-param variant (same code path, longer wall time).

    PYTHONPATH=src python -m repro_torch.examples.lm_pretrain --steps 200 \\
        [--full] [--device {cuda,cpu}]

Weights come from `models.model.init_params` with a generator seeded 0 on
the device (the reference's jax.random.PRNGKey(0) draws other values);
the batches are SyntheticLMDataset's numpy draws. The train step
(`make_train_step`, eager autograd) runs under `train.fault.Supervisor`
on a mesh of one rank (`launch.mesh.make_host_mesh`: a process group of
world size 1, started here unless one is running and then destroyed at
the end). Checkpoints go under the repository's build/ by default.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch
import torch.distributed as dist

from repro_torch.core.context import resolve_device
from repro_torch.data.pipeline import SyntheticLMDataset, shard_batch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.train.fault import Supervisor
from repro_torch.train.optim import adamw_init

SMALL = ArchConfig(name="lm-27m", family="dense", n_layers=6, d_model=384,
                   d_ff=1536, vocab=32000, n_heads=6, n_kv_heads=6,
                   head_dim=64, attention="gqa")
FULL = ArchConfig(name="lm-115m", family="dense", n_layers=10, d_model=640,
                  d_ff=2560, vocab=50304, n_heads=10, n_kv_heads=10,
                  head_dim=64, attention="gqa")
CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        *[os.pardir] * 3, "build", "repro_torch",
                        "lm_pretrain_ckpt")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.normpath(CKPT_DIR))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model trains (cuda, the default, "
                         "raises without a CUDA device)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = FULL if args.full else SMALL
    started = not dist.is_initialized()
    mesh = make_host_mesh(device=dev)
    try:
        params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               dev)
        n_params = cfg.param_count()
        print(f"{cfg.name}: {n_params/1e6:.1f}M params, "
              f"{args.steps} steps x {args.batch}x{args.seq} tokens")

        opt = adamw_init(params)
        ds = SyntheticLMDataset(cfg, args.batch, args.seq)
        step_fn = M.make_train_step(cfg, mesh, learning_rate=6e-4)
        sup = Supervisor(step_fn, args.ckpt_dir, ckpt_every=100, device=dev)
        t0 = time.time()
        (params, opt), hist = sup.run(
            (params, opt), lambda s: shard_batch(ds.batch_at(s), dev),
            args.steps)
        dt = time.time() - t0
    finally:
        if started:
            dist.destroy_process_group()
    first = sum(h["loss"] for h in hist[:10]) / 10
    last = sum(h["loss"] for h in hist[-10:]) / 10
    print(f"loss: first10={first:.4f} last10={last:.4f} "
          f"(delta {first-last:+.4f})")
    tput = args.steps * args.batch * args.seq / dt
    print(f"throughput: {tput:.0f} tok/s ({dt:.1f}s total); "
          f"model flops/step ~ {6*n_params*args.batch*args.seq/1e9:.1f} GFLOP")
    assert last < first, "loss did not decrease"
    return {"first10": first, "last10": last, "tok_s": tput, "seconds": dt,
            "history": hist, "n_params": n_params}


if __name__ == "__main__":
    main(sys.argv[1:])
