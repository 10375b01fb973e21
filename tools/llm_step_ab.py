"""Time, on one CUDA card, the decode step and the train step that
chip_smoke.py's llm and train phases time, for one tree of this repo:
qwen3-8b served at batch 8 (prompt 32, 32 generated tokens; the median
decode step, device-synchronised) and qwen3-8b cut to 16 layers in bf16
trained at launch/train's defaults (batch 8 x seq 128; the median of 5
steps after 1).

    python tools/llm_step_ab.py TREE LABEL

To compare two commits on the same card, unpack the other one with
`git archive` under build/ and time the trees in turns in one command:

    for t in build/parent:parent .:change .:change build/parent:parent; do
        python tools/llm_step_ab.py ${t%%:*} ${t##*:}; done
"""
import dataclasses
import os
import statistics
import sys
import time

tree, label = sys.argv[1], sys.argv[2]
sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    SyntheticLMDataset, shard_batch)
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import serve, train as launch_train  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train import optim  # noqa: E402

dev = torch.device("cuda")
args = serve.parse_args(["--arch", "qwen3-8b", "--device", "cuda", "--batch",
                         "8", "--prompt-len", "32", "--gen", "32"])
res = serve.serve(args)
dec = statistics.median(res.decode_step_s) * 1e3
del res
torch.cuda.empty_cache()

mesh_mod.STORE_DIR.mkdir(parents=True, exist_ok=True)
store = mesh_mod.STORE_DIR / f"ab-{os.getpid()}"
dist.init_process_group("cpu:gloo,cuda:nccl", init_method=f"file://{store}",
                        world_size=1, rank=0)
mesh = mesh_mod.make_host_mesh(device=dev)
cfg = dataclasses.replace(get_config("qwen3-8b"), n_layers=16)
targs = launch_train.parse_args([])
params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
opt = optim.adamw_init(params)
ds = SyntheticLMDataset(cfg, targs.batch, targs.seq)
step = M.make_train_step(cfg, mesh, learning_rate=targs.lr)
times = []
for i in range(6):
    batch = shard_batch(ds.batch_at(i), dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt, metrics = step(params, opt, batch)
    torch.cuda.synchronize()
    times.append(time.perf_counter() - t0)
dist.destroy_process_group()
print(f"AB {label}: decode {dec:.3f} ms a step (median of "
      f"{args.gen}), train {statistics.median(times[1:]) * 1e3:.3f} ms a "
      f"step (median of 5 after 1)", flush=True)
