"""One rank of a multi-rank scenario of the port's distributed layer
(repro_torch.fhe_dist over torch.distributed with gloo on the CPU).

    python tests/_torch_dist_worker.py SCENARIO WORLD RANK STORE OUT [ARGS]

The parent test (tests/test_torch_distributed.py) starts WORLD of these,
one process a rank, all on the file store STORE. Each rank writes what
it computed to OUT/rank<RANK>.npz and prints WORKER_OK; the parent holds
the arrays to the JAX package. Integer results must be bit-exact.

Scenarios:
* ``bconv VARIANT DATA MODEL`` — distributed_bconv (ring or allgather)
  on a DATA x MODEL mesh at test_params(log_n=8, n_levels=7, dnum=2):
  the 8 Q limbs onto themselves (the reference worker's case), and onto
  8 destinations with the 32-bit primes 3221225473 and 4293918721.
* ``pipeline`` — run_load_save_pipeline on a WORLD-rank `data` ring, two
  rounds (the reference worker's stage functions).
"""
import os
import sys
from datetime import timedelta

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

# destinations beyond the 30-bit test primes: paper_params_bootstrap's
# special prime and the largest NTT prime below 2^32 (2^32 - 2^20 + 1)
WIDE_PRIMES = (3221225473, 4293918721)


def bconv_inputs():
    """(ctx, v, src, dst, dst_wide_primes), the same on every rank and in
    the parent: v drawn as the reference worker draws it."""
    from repro_torch.core.context import CkksContext
    from repro_torch.core.params import test_params
    ctx = CkksContext(test_params(log_n=8, n_levels=7, dnum=2), "cpu")
    src = dst = ctx.q_idx(7)
    rng = np.random.default_rng(0)
    v = np.stack([rng.integers(0, ctx.primes[i], size=ctx.n, dtype=np.uint64)
                  for i in src]).astype(np.int64)
    wide = [ctx.primes[i] for i in dst[:6]] + list(WIDE_PRIMES)
    return ctx, v, src, dst, wide


def scenario_bconv(variant, data, model):
    from repro_torch.core import rns
    from repro_torch.fhe_dist.collective_bconv import (bconv_tables_device,
                                                       distributed_bconv)
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh((data, model), ("data", "model"), torch.device("cpu"))
    ctx, v, src, dst, wide = bconv_inputs()
    vt = torch.from_numpy(v)
    tabs = bconv_tables_device(ctx, src, dst)
    out = {"coords": np.array(mesh.coords),
           "peers": np.array([mesh.peer("model", 1), mesh.peer("model", -1),
                              mesh.peer("data", 1)]),
           "block": distributed_bconv(vt, *tabs, mesh, variant=variant),
           "full": distributed_bconv(vt, *tabs, mesh, variant=variant,
                                     gather=True)}
    t = rns.make_bconv_tables([ctx.primes[i] for i in src], wide,
                              torch.device("cpu"))
    wide_tabs = (t.qhat_inv, t.src_q, t.w, t.dst_q)
    out["full_wide"] = distributed_bconv(vt, *wide_tabs, mesh,
                                         variant=variant, gather=True)
    out["want_wide"] = rns.bconv(vt, t)
    return out


def pipeline_case(world):
    """(x, rounds): the reference worker's input and stage functions."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(5, 16, 32)).astype(np.float32)
    fns_r1 = [lambda v, k=k: v * (k + 1) for k in range(world)]
    fns_r2 = [lambda v, k=k: v + k for k in range(world)]
    return x, [fns_r1, fns_r2]


def scenario_pipeline(world):
    from repro_torch.fhe_dist.pipeline_exec import run_load_save_pipeline
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh((world,), ("data",), torch.device("cpu"))
    x, rounds = pipeline_case(world)
    return {"out": run_load_save_pipeline(rounds, torch.from_numpy(x), mesh)}


def main(argv):
    scenario, world, rank, store, out_dir = argv[:5]
    world, rank = int(world), int(rank)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=60))
    try:
        if scenario == "bconv":
            variant, data, model = argv[5], int(argv[6]), int(argv[7])
            out = scenario_bconv(variant, data, model)
        elif scenario == "pipeline":
            out = scenario_pipeline(world)
        else:
            raise SystemExit(f"unknown scenario {scenario}")
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: np.asarray(v) for k, v in out.items()})
    print("WORKER_OK")


if __name__ == "__main__":
    main(sys.argv[1:])
