"""Count the ATen ops that the plain (one-rank) decode step and train step
of one tree of this repo dispatch, on the CPU: qwen3-8b's smoke config
cut to 8 layers, one decode step at batch 8 over 64 cache slots, one
train step at batch 2 x seq 16, each after a warm-up step. Two trees
whose steps dispatch the same ops launch the same kernels on a card, so
a step-time difference between them is host time.

    python tools/plain_step_ops.py TREE LABEL

prints `OPS LABEL: decode N, train M` and then a JSON line of each op's
count, to compare two trees (e.g. a `git archive` of the parent under
build/ and the change):

    for t in build/parent:parent .:change; do
        python tools/plain_step_ops.py ${t%%:*} ${t##*:}; done
"""
import collections
import dataclasses
import json
import os
import sys

tree, label = sys.argv[1], sys.argv[2]
sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))

import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.compat import abstract_mesh  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train import optim  # noqa: E402


class Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.count = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count[str(func)] += 1
        return func(*args, **(kwargs or {}))


cpu = torch.device("cpu")
cfg = dataclasses.replace(get_config("qwen3-8b", smoke=True), n_layers=8)
params = M.init_params(cfg, torch.Generator().manual_seed(0), cpu)
cache = M.init_cache(cfg, 8, 64, cpu)
serve = M.make_serve_step(cfg)
tok = torch.zeros(8, dtype=torch.int32)
serve(params, cache, tok, 3)
with Ops() as dec:
    serve(params, cache, tok, 4)

step = M.make_train_step(cfg, abstract_mesh((1, 1), ("data", "model")))
opt = optim.adamw_init(params)
batch = {"tokens": torch.zeros((2, 16), dtype=torch.int32)}
batch["labels"] = batch["tokens"]
step(params, opt, batch)
with Ops() as train:
    step(params, opt, batch)

print(f"OPS {label}: decode {sum(dec.count.values())}, train "
      f"{sum(train.count.values())}", flush=True)
print(json.dumps({"label": label, "decode": dec.count, "train": train.count},
                 sort_keys=True))
