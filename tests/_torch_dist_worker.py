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
* ``limb VARIANT DATA MODEL`` — core.ops on the limb-sharded basis
  (fhe_dist.limb_ops.LimbShard, BConv schedule VARIANT) on a DATA x
  MODEL mesh: hmul (with rescale),
  hsquare, rotate and an hmul against a ciphertext switched down to
  LOW_LEVEL, on the reference worker's hmul inputs (`limb_inputs`), on a
  batch of two ciphertexts split along `data`, and at a small ring with
  3221225473 among its special primes; each result gathered, and the
  rank's own block of hmul. Also distributed_bconv from 12 limbs onto 7,
  which split over 8 or 4 ranks unevenly.
* ``moe`` — models.moe.moe_all_to_all on a (1, WORLD) mesh: each rank
  routes its own block of `moe_inputs`' tokens and holds its block of
  the experts; the output, the aux loss and the gradients of
  sum(out ** 2) + aux with respect to the rank's tokens, router and
  experts.
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


# the reference worker's limb-sharded hmul parameters (8 Q limbs, 4
# special limbs, 2 digits of 4), and a small ring whose 8 special primes
# hold 3221225473 and 4293918721 (one digit of 8)
REF_PARAMS = dict(log_n=8, log_scale=26, n_levels=7, dnum=2,
                  first_mod_bits=30, scale_mod_bits=26, special_mod_bits=30)
WIDE_PARAMS = dict(log_n=6, log_scale=26, n_levels=7, dnum=1,
                   first_mod_bits=30, scale_mod_bits=26, special_mod_bits=31)
ROT_STEP = 3
LOW_LEVEL = 4
# each scenario of the limb case: (parameters, whether a batch of two)
LIMB_CASES = {"ref": (REF_PARAMS, False), "batch": (REF_PARAMS, True),
              "wide": (WIDE_PARAMS, False)}
LIMB_OPS = ("hmul", "hsquare", "rotate", "low")


def limb_inputs(params_kw):
    """(ctx, rk, gk, ct1, ct2) on the CPU: the reference worker's hmul
    inputs (CkksEncryptor seed 5, rng 2, scale 2^26 at the top level),
    then the Galois key of ROT_STEP, drawn after them."""
    from repro_torch.core.ciphertext import Plaintext
    from repro_torch.core.context import CkksContext
    from repro_torch.core.encoder import CkksEncoder
    from repro_torch.core.encryptor import CkksEncryptor
    from repro_torch.core.params import CkksParams
    params = CkksParams(**params_kw)
    ctx = CkksContext(params, "cpu")
    enc = CkksEncoder(ctx)
    encr = CkksEncryptor(ctx, seed=5)
    sk = encr.keygen()
    rk = encr.relin_keygen(sk)
    rng = np.random.default_rng(2)
    s = ctx.n // 2
    v1 = rng.normal(size=s) * 0.3
    v2 = rng.normal(size=s) * 0.3
    scale = 2.0 ** 26
    lvl = params.n_levels
    ct1 = encr.encrypt_sk(Plaintext(enc.encode(v1, scale, lvl), lvl, scale),
                          sk)
    ct2 = encr.encrypt_sk(Plaintext(enc.encode(v2, scale, lvl), lvl, scale),
                          sk)
    gk = encr.rotation_keygen(sk, [ROT_STEP])[
        ctx.rotation_element(ROT_STEP)]
    return ctx, rk, gk, ct1, ct2


def limb_operands(ct1, ct2, batch):
    """The two operands of a limb case: (ct1, ct2), or the batch
    (ct1, ct2) against (ct2, ct2)."""
    from repro_torch.core.ciphertext import Ciphertext
    if not batch:
        return ct1, ct2
    return (Ciphertext(torch.stack([ct1.data, ct2.data]), ct1.level,
                       ct1.scale),
            Ciphertext(torch.stack([ct2.data, ct2.data]), ct2.level,
                       ct2.scale))


def uneven_bconv_inputs():
    """(ctx, v, src, dst): 12 limbs (Q and P of REF_PARAMS) onto the 7
    Q limbs of level 6, v drawn as `bconv_inputs` draws it."""
    from repro_torch.core.context import CkksContext
    from repro_torch.core.params import CkksParams
    ctx = CkksContext(CkksParams(**REF_PARAMS), "cpu")
    src, dst = ctx.q_idx(7) + ctx.p_idx(), ctx.q_idx(6)
    rng = np.random.default_rng(0)
    v = np.stack([rng.integers(0, ctx.primes[i], size=ctx.n, dtype=np.uint64)
                  for i in src]).astype(np.int64)
    return ctx, v, src, dst


def limb_results(ctx, sh, a, b, rk, gk):
    """LIMB_OPS of the sharded operands a, b on the basis `sh`, each with
    its keys sharded by `limb_ops.shard_key`."""
    from repro_torch.core import ops
    from repro_torch.fhe_dist import limb_ops as lo
    top = ctx.params.n_levels
    rk_top = lo.shard_key(sh, ctx, rk, top)
    return {"hmul": ops.hmul(ctx, a, b, rk_top, basis=sh),
            "hsquare": ops.hsquare(ctx, a, rk_top, basis=sh),
            "rotate": ops.rotate(ctx, a, ROT_STEP,
                                 lo.shard_key(sh, ctx, gk, top), basis=sh),
            "low": ops.hmul(ctx, a, ops.mod_switch_to_level(b, LOW_LEVEL, sh),
                            lo.shard_key(sh, ctx, rk, LOW_LEVEL), basis=sh)}


def scenario_limb(variant, data, model):
    from repro_torch.fhe_dist import limb_ops as lo
    from repro_torch.fhe_dist.collective_bconv import (bconv_tables_device,
                                                       distributed_bconv)
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh((data, model), ("data", "model"), torch.device("cpu"))
    sh = lo.LimbShard(mesh, variant)
    out = {}
    for case, (params_kw, batch) in LIMB_CASES.items():
        ctx, rk, gk, ct1, ct2 = limb_inputs(params_kw)
        a, b = (lo.shard_ciphertext(sh, c)
                for c in limb_operands(ct1, ct2, batch))
        res = limb_results(ctx, sh, a, b, rk, gk)
        for name, ct in res.items():
            whole = lo.gather_ciphertext(sh, ct).data
            if batch:
                # two ciphertexts split evenly along `data`
                whole = mesh.all_gather(whole, "data")
            out[f"{case}_{name}"] = whole
            out[f"{case}_{name}_meta"] = np.array([ct.level, ct.scale])
        out[f"{case}_hmul_block"] = res["hmul"].data
    ctx, v, src, dst = uneven_bconv_inputs()
    out["bconv_uneven"] = distributed_bconv(
        torch.from_numpy(v), *bconv_tables_device(ctx, src, dst), mesh,
        variant=variant, gather=True)
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


def moe_inputs(world):
    """(cfg, x (16 * WORLD, D), expert weights of all experts): the
    deepseek smoke config in float32, 16 tokens a rank routed mostly to
    expert 3 (capacity 5 a rank: slots are dropped)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("deepseek-v3-671b", smoke=True),
                              dtype="float32")
    rng = np.random.default_rng(12)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    p = {"w_router": rng.normal(size=(d, e)),
         "w_gate": 0.1 * rng.normal(size=(e, d, f)),
         "w_up": 0.1 * rng.normal(size=(e, d, f)),
         "w_down": 0.1 * rng.normal(size=(e, f, d))}
    p["w_router"][:, 3] += 0.5
    x = rng.normal(size=(16 * world, d)) + 0.5
    return cfg, x.astype(np.float32), {k: v.astype(np.float32)
                                       for k, v in p.items()}


def moe_run(fn, x, p):
    """fn(x, p) -> (out, aux) and the gradients of sum(out ** 2) + aux
    with respect to x and every weight, as numpy."""
    xs = torch.tensor(x, requires_grad=True)
    ps = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    out, aux = fn(xs, ps)
    grads = torch.autograd.grad((out * out).sum() + aux,
                                [xs] + list(ps.values()))
    res = {"out": out.detach().numpy(), "aux": aux.detach().numpy()}
    res.update({f"g_{k}": g.numpy() for k, g in
                zip(["x"] + list(ps), grads)})
    return res


def scenario_moe(world):
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.moe import moe_all_to_all
    mesh = Mesh((1, world), ("data", "model"), torch.device("cpu"))
    cfg, x, p = moe_inputs(world)
    r = mesh.axis_index("model")
    t, e_l = x.shape[0] // world, cfg.n_experts // world
    mine = {k: (v if k == "w_router" else v[r * e_l:(r + 1) * e_l])
            for k, v in p.items()}
    return moe_run(lambda xs, ps: moe_all_to_all(xs, ps, cfg, mesh),
                   x[r * t:(r + 1) * t], mine)


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
        elif scenario == "limb":
            variant, data, model = argv[5], int(argv[6]), int(argv[7])
            out = scenario_limb(variant, data, model)
        elif scenario == "moe":
            out = scenario_moe(world)
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
