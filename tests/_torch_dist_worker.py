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
* ``sharded ARCH DATA MODEL [IMG_TOKENS]`` — the partitioned LLM step
  (DTensors on the DATA x MODEL mesh) of ARCH's smoke config in float32
  (with IMG_TOKENS image tokens where given) on
  tests/_sharded_inputs.py's inputs: forward and loss_fn, one
  make_train_step step, the prefill step, DECODE_STEPS greedy decode
  steps under the serving rules, each output gathered whole
  (`full_tensor`); rank 0 also runs the same steps unsharded (plain
  tensors, a device-less mesh of one rank) under "plain/...", and counts
  the collectives of the prefill step cut to one MoE layer (MoE archs)
  under "count/..." (by kind) and "count_op/..." (by op), and those of
  one decode step under "count_decode_op/...". For an RG-LRU stack also
  `_ring_local_decode` of its first superblock's attention layer on
  DTensors (the ring laid out as the serving rules lay out its cache)
  over RING_STEPS positions of a zero ring whose slot positions start
  at 0 and at -1 (F5), under "ring/...".
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


def _flat(tree, prefix):
    """{prefix/path: tensor} of a tree of dicts, tuples and lists (keys in
    sorted order, sequence items by index: jax's paths)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, t in enumerate(tree):
            out.update(_flat(t, f"{prefix}/{i}"))
        return out
    if tree is None:
        return {}
    return {prefix: tree}


def sharded_setup(arch, img_tokens=None):
    """(cfg, whole params, batch, cache) as numpy-drawn trees: the smoke
    config in float32 (with `img_tokens` image tokens where given) and
    tests/_sharded_inputs.py's draws."""
    import dataclasses
    import _sharded_inputs as si
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    if img_tokens:
        cfg = dataclasses.replace(cfg, n_img_tokens=img_tokens)
    schema = list(M.tree_items(M.param_schema(cfg)))
    drawn = si.draw_params([(p, ps.shape, ps.scale) for p, ps in schema])
    params = M.tree_unflatten([p for p, _ in schema],
                              [torch.from_numpy(drawn[p]) for p, _ in schema])
    batch = si.draw_batch(cfg.vocab, cfg.d_model, cfg.enc_dec,
                          cfg.n_img_tokens if cfg.xattn_period else 0)
    cschema = list(M.tree_items(M.cache_schema(cfg, si.B, si.S_MAX)))
    cdrawn = si.draw_cache([(p, ps.shape, ps.logical) for p, ps in cschema],
                           si.history(cfg.rglru))
    cache = M.tree_unflatten([p for p, _ in cschema],
                             [torch.from_numpy(cdrawn[p]) for p, _ in cschema])
    return cfg, params, batch, cache


def sharded_steps(cfg, params, batch, cache, mesh, put, put_params,
                  put_cache, gather):
    """Every step of the partitioned-step scenario: `put` lays a host
    batch out, `put_params(params, rules)` and `put_cache` the trees,
    `gather` makes a result whole."""
    import _sharded_inputs as si
    from repro_torch.models import model as M
    from repro_torch.sharding.rules import serving_rules
    from repro_torch.train import optim
    out = {}
    p = put_params(params, None)
    b = put(batch)
    logits, mtp, aux, _ = M.forward(p, cfg, b, mesh)
    loss, metrics = M.loss_fn(p, cfg, b, mesh)
    out.update(logits=logits, aux=aux, loss=loss)
    if mtp is not None:
        out["mtp"] = mtp
    out.update(_flat(metrics, "metrics"))
    step = M.make_train_step(cfg, mesh)
    new_p, new_o, tm = step(put_params(params, None), optim.adamw_init(p),
                            b)
    out.update(_flat(new_p, "new_params"))
    out.update(_flat({"m": new_o["m"], "v": new_o["v"]}, "opt"))
    out.update(_flat(tm, "train_metrics"))
    with torch.no_grad():
        last, caches = M.make_prefill_step(cfg, mesh)(
            p, {k: v for k, v in b.items() if k != "labels"})
        out["prefill_logits"] = last
        out.update(_flat(caches, "prefill_cache"))
        rules = serving_rules()
        dp = put_params(params, rules)
        c = put_cache(M.tree_map(torch.clone, cache), rules)
        tok = put({"t": si.first_tokens(cfg.vocab)})["t"]
        serve = M.make_serve_step(cfg, mesh)
        first = si.history(cfg.rglru)
        for i in range(si.DECODE_STEPS):
            lg, c = M.decode_forward(dp, cfg, c, tok, first + i, mesh)
            out[f"decode_logits/{i}"] = lg
            tok = torch.argmax(lg, dim=-1).to(torch.int32)
            out[f"decode_tokens/{i}"] = tok
        out.update(_flat(c, "decode_cache"))
        # serve_step is decode_forward and the argmax: one more step
        nt, _ = serve(dp, put_cache(M.tree_map(torch.clone, cache), rules),
                      put({"t": si.first_tokens(cfg.vocab)})["t"],
                      first)
        out["serve_tokens"] = nt
    return {k: gather(v) for k, v in out.items()}


def ring_runs(cfg, params, mesh):
    """_ring_local_decode of the first superblock's attention layer, its
    weights, activations and ring laid out on `mesh` under the serving
    rules, over RING_STEPS positions of a zero ring of S_MAX slots whose
    positions start at 0 and at -1; each output gathered whole."""
    import _sharded_inputs as si
    from repro_torch.models import model as M
    from repro_torch.sharding.dtensor import distribute
    from repro_torch.sharding.rules import serving_rules
    rules = serving_rules()
    i = (cfg.block_pattern or ("rglru", "rglru", "attn")).index("attn")
    dp = M.distribute_params(M.tree_map(torch.clone, params), cfg, mesh,
                             rules)
    bp = M._layer(dp["superblocks"], 0)[f"l{i}_attn"]
    specs = M.cache_specs(cfg, mesh, si.B, si.S_MAX, rules)
    shape = (si.B, max(cfg.n_kv_heads, 1), si.S_MAX, cfg.resolved_head_dim)
    out = {}
    with torch.no_grad():
        for init in (0, -1):
            kc, vc = (distribute(torch.zeros(shape), mesh,
                                 specs[f"k_{i}"][1:]) for _ in range(2))
            kp = distribute(torch.full((si.S_MAX,), init, dtype=torch.int32),
                            mesh, specs[f"pos_{i}"][1:])
            for pos, x in enumerate(si.draw_ring(cfg.d_model)):
                xd = distribute(torch.from_numpy(x), mesh,
                                (("data",), None, None))
                o, kc, vc, kp = M._ring_local_decode(xd, bp, cfg, kc, vc, kp,
                                                     pos)
                out[f"ring/{init}/out/{pos}"] = o
            out.update({f"ring/{init}/k": kc, f"ring/{init}/v": vc,
                        f"ring/{init}/pos": kp})
    return {k: v.full_tensor().numpy() for k, v in out.items()}


def scenario_sharded(arch, data, model, img_tokens=None):
    import dataclasses
    import _sharded_inputs as si
    from repro_torch.compat import abstract_mesh
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch.dryrun import StepCounter
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import model as M
    cpu = torch.device("cpu")
    mesh = Mesh((data, model), ("data", "model"), cpu)
    cfg, params, batch, cache = sharded_setup(arch, img_tokens)
    si_b, si_s = si.B, si.S_MAX

    def whole(t):
        t = t.full_tensor() if hasattr(t, "full_tensor") else t
        return t.detach().numpy()

    out = sharded_steps(
        cfg, params, batch, cache, mesh,
        lambda bt: shard_batch(bt, mesh, torch.float32),
        lambda p, rules: M.distribute_params(M.tree_map(torch.clone, p),
                                             cfg, mesh, rules),
        lambda c, rules: M.distribute_cache(c, cfg, mesh, si_b, si_s, rules),
        whole)
    if cfg.n_experts:
        # the prefill cut to one MoE layer: the reference's HLO holds a
        # scanned layer's body once
        cut = dataclasses.replace(cfg, n_layers=cfg.first_k_dense + 1)
        cp = M.distribute_params(
            M.init_params(cut, torch.Generator().manual_seed(0), cpu), cut,
            mesh)
        pb = shard_batch({k: v for k, v in batch.items() if k != "labels"},
                         mesh, torch.float32)
        with torch.no_grad(), StepCounter() as cnt:
            M.make_prefill_step(cut, mesh)(cp, pb)
        out.update({f"count/{k}": np.array(v)
                    for k, v in cnt.collective_bytes.items()})
        out.update({f"count_op/{k}": np.array(v)
                    for k, v in cnt.bytes_by_op.items()})
        # one decode step: the MoE layers' psum route
        from repro_torch.sharding.rules import serving_rules
        rules = serving_rules()
        dp = M.distribute_params(M.tree_map(torch.clone, params), cfg, mesh,
                                 rules)
        c = M.distribute_cache(M.tree_map(torch.clone, cache), cfg, mesh,
                               si_b, si_s, rules)
        tok = shard_batch({"t": si.first_tokens(cfg.vocab)}, mesh)["t"]
        with torch.no_grad(), StepCounter() as cnt:
            M.decode_forward(dp, cfg, c, tok, si.HISTORY, mesh)
        out.update({f"count_decode_op/{k}": np.array(v)
                    for k, v in cnt.bytes_by_op.items()})
    if cfg.rglru:
        out.update(ring_runs(cfg, params, mesh))
    if dist.get_rank() == 0:
        one = abstract_mesh((1, 1), ("data", "model"))
        plain = sharded_steps(
            cfg, params, batch, cache, one,
            lambda bt: shard_batch(bt, cpu, torch.float32),
            lambda p, rules: M.tree_map(torch.clone, p),
            lambda c, rules: c, lambda t: t.detach().numpy())
        out.update({f"plain/{k}": v for k, v in plain.items()})
    return out


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
        elif scenario == "sharded":
            out = scenario_sharded(argv[5], int(argv[6]), int(argv[7]),
                                   int(argv[8]) if len(argv) > 8 else None)
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
