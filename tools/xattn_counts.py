"""Count llama-3.2-vision-90b's unsharded matmul FLOPs (FlopCounterMode on
meta tensors, the dry run's `matmul_flops`) at full width cut to one
superblock (n_layers 100 -> 5) for one tree of this repo, on the CPU, and
the p.v product P = 2 * B * Hq * Sq * 1601 * dh of one cross-attention
layer and pass at each shape.

    python tools/xattn_counts.py TREE LABEL

prints one line a shape: `COUNT LABEL shape total P seconds`. A tree
whose cross attention runs F6's 1601 one-token chunks on meta tensors
leaves P out of the count (the one-token chunk's p.v einsum contracts a
dim of size 1 and runs as an elementwise multiply); one that folds the
chunks counts it once a pass: the two trees' totals differ by P at
decode_32k and prefill_32k and by 3 * P at train_4k (the forward and its
two backward products). E.g. a `git archive` of a tree of the first kind
under build/ against this one:

    for t in build/parent:parent .:change; do
        python tools/xattn_counts.py ${t%%:*} ${t##*:}; done
"""
import dataclasses
import os
import sys

tree, label = sys.argv[1], sys.argv[2]
sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.specs import SHAPES, build_cell  # noqa: E402

ARCH = "llama-3.2-vision-90b"

cfg = dataclasses.replace(get_config(ARCH), n_layers=5)
for shape in ("decode_32k", "prefill_32k", "train_4k"):
    c = dryrun.count_matmul_flops(build_cell(ARCH, shape, dryrun.mesh_of(False),
                                             cfg_override=cfg))
    sq = 1 if SHAPES[shape]["kind"] == "decode" else SHAPES[shape]["seq"]
    pv = (2 * SHAPES[shape]["batch"] * cfg.n_heads * sq * cfg.n_img_tokens
          * cfg.resolved_head_dim)
    print(f"COUNT {label} {shape} {c['matmul_flops']} {pv} "
          f"{c['count_s']:.1f}", flush=True)
