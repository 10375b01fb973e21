"""The port's partitioned layouts and collective counts on meta tensors
over fake process groups, in a process of their own (a fake group must
be the process's default group).

    python tests/_torch_fake_counts.py shapes OUT.json
    python tests/_torch_fake_counts.py toy OUT.json
    python tests/_torch_fake_counts.py smoke OUT.json
    python tests/_torch_fake_counts.py vision OUT.json
    python tests/_torch_fake_counts.py forward OUT.json

* ``shapes`` — every cell of launch.specs.build_cell on the production
  meshes of 256 and 512 ranks (launch.mesh.fake_production_mesh): for
  each DTensor argument (parameters, AdamW state, batch, cache, tokens)
  its path, its local shape on rank 0 and sharding.rules.shard_shape of
  its spec, for tests/test_torch_dryrun.py to hold to the reference's
  NamedSharding.shard_shape.
* ``toy`` — a two-layer dense toy (TOY) on a (data 2, model 4) mesh of 8
  fake ranks: launch.dryrun.StepCounter's collective bytes by kind of
  its prefill step and of its train step, and its parameters' local
  shapes, for tests/test_torch_sharded_dryrun.py's count by hand.
* ``smoke`` — the prefill step of the smoke configs of
  tests/_sharded_inputs.py's ARCHS, of RECURRENT and of VISION in
  float32, cut to
  one layer of each kind as tests/_jax_sharded_step.py cuts them, at its
  batch on its (2, 4) mesh of 8 fake ranks: the collective bytes per
  device by kind, beside which PERF.md sets the reference's HLO count of
  the same cell. For RECURRENT also StepCounter's collective bytes and
  FLOPs of the train, prefill and decode steps of the whole smoke config
  on meta tensors (each time loop one step batched over T) and on real
  CPU tensors (the loop over T), under "loop_counts".
* ``vision`` — the same fold and loop counts of llama-3.2-vision-90b's
  smoke config (one superblock) at VISION_TOKENS image tokens: on meta
  tensors its cross attention runs as one chunk, on real ones in
  `_divisor_chunk`'s chunks (one token each at the prime 1031).
* ``forward`` — models.forward of every arch's smoke config in float32
  on meta DTensors laid out on a (2, 4) mesh of 8 fake ranks, at
  tests/_sharded_inputs.py's batch (with its `frames` or `images`): the
  logits' shape, or the exception it raised.
"""
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.dirname(__file__))

import torch  # noqa: E402

TOY = dict(name="toy", family="dense", n_layers=2, d_model=16, d_ff=32,
           vocab=32, n_heads=4, n_kv_heads=4, head_dim=4, dtype="float32")
TOY_BATCH, TOY_SEQ = 4, 8
RECURRENT = ("rwkv6-3b", "recurrentgemma-2b")
VISION = "llama-3.2-vision-90b"
VISION_TOKENS = (1031, 17)


def _leaves(tree, specs, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], specs[k], f"{prefix}{k}/")
    elif isinstance(tree, (tuple, list)):
        for i, (t, s) in enumerate(zip(tree, specs, strict=True)):
            yield from _leaves(t, s, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree, specs


def shapes():
    from repro_torch.configs import list_archs
    from repro_torch.launch.mesh import fake_production_mesh
    from repro_torch.launch.specs import SHAPES, build_cell
    from repro_torch.sharding.rules import shard_shape
    out = {}
    for multi_pod in (False, True):
        with fake_production_mesh(multi_pod=multi_pod) as mesh:
            name = "2x16x16" if multi_pod else "16x16"
            for arch in list_archs():
                for shape in SHAPES:
                    cell = build_cell(arch, shape, mesh)
                    if cell["skip"]:
                        continue
                    out[f"{arch}|{shape}|{name}"] = [
                        [p, list((x.to_local() if hasattr(x, "to_local")
                                  else x).shape),
                         list(shard_shape(mesh, s, x.shape))]
                        for p, x, s in _leaves(cell["args"],
                                               cell["in_specs"])
                        if not isinstance(x, int)]
    return out


def toy():
    from repro_torch.compat import fake_process_group
    from repro_torch.launch.dryrun import StepCounter
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import model as M
    from repro_torch.models.config import ArchConfig
    from repro_torch.sharding.dtensor import distribute
    from repro_torch.train.optim import abstract_adamw_state
    cfg = ArchConfig(**TOY)
    out = {}
    with fake_process_group(8):
        mesh = Mesh((2, 4), ("data", "model"), torch.device("meta"),
                    device_type="cuda")

        def batch(labels):
            names = ("tokens", "labels") if labels else ("tokens",)
            return {k: distribute(torch.empty(TOY_BATCH, TOY_SEQ,
                                              dtype=torch.int32,
                                              device="meta"),
                                  mesh, (("data",), None)) for k in names}

        params = M.abstract_params(cfg, mesh)
        out["local_shapes"] = {"/".join(p): list(t.to_local().shape)
                               for p, t in M.tree_items(params)}
        out["specs"] = {"/".join(p): list(s) for p, s in M.tree_items(
            M.param_specs(cfg, mesh))}
        with StepCounter() as c:
            M.make_prefill_step(cfg, mesh)(params, batch(False))
        out["prefill"] = c.collective_bytes
        with StepCounter() as c:
            M.make_train_step(cfg, mesh)(
                params, abstract_adamw_state(params), batch(True))
        out["train"] = c.collective_bytes
    return out


def _cut(cfg):
    """tests/_jax_sharded_step.py's cut_config."""
    if cfg.xattn_period:
        return dataclasses.replace(cfg, n_layers=cfg.xattn_period + 1)
    if cfg.rglru:
        pattern = cfg.block_pattern or ("rglru", "rglru", "attn")
        return dataclasses.replace(cfg, n_layers=len(pattern) + 1)
    return dataclasses.replace(cfg, n_layers=cfg.first_k_dense + 1)


def _step_counts(cfg, device):
    """StepCounter's (collective bytes by kind, FLOPs) of the train,
    prefill and decode steps of `cfg` at tests/_sharded_inputs.py's sizes
    on a (2, 4) mesh of the fake group: on meta DTensors, or on real ones
    (zero tokens, images and cache, weights from a seeded generator) on
    the CPU."""
    import _sharded_inputs as si
    from repro_torch.launch.dryrun import StepCounter
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import model as M
    from repro_torch.sharding.dtensor import distribute
    from repro_torch.sharding.rules import serving_rules
    from repro_torch.train import optim
    meta = device.type == "meta"
    mesh = Mesh(si.MESH, ("data", "model"), device, device_type="cpu")
    rules = serving_rules()

    def params(r=None):
        if meta:
            return M.abstract_params(cfg, mesh, r)
        return M.distribute_params(M.init_params(
            cfg, torch.Generator().manual_seed(0), device), cfg, mesh, r)

    def tokens(*shape):
        return distribute(torch.zeros(shape, dtype=torch.int32,
                                      device=device), mesh,
                          (("data",),) + (None,) * (len(shape) - 1))

    cache = (M.abstract_cache(cfg, si.B, si.S_MAX, mesh, rules) if meta
             else M.distribute_cache(M.init_cache(cfg, si.B, si.S_MAX,
                                                  device),
                                     cfg, mesh, si.B, si.S_MAX, rules))
    def batch(labels):
        out = {"tokens": tokens(si.B, si.S)}
        if labels:
            out["labels"] = tokens(si.B, si.S)
        if cfg.xattn_period:
            out["images"] = distribute(
                torch.zeros((si.B, cfg.n_img_tokens, cfg.d_model),
                            device=device), mesh, (("data",), None, None))
        return out

    p = params()
    steps = {
        "train": lambda: M.make_train_step(cfg, mesh)(
            p, optim.abstract_adamw_state(p) if meta else optim.adamw_init(p),
            batch(True)),
        "prefill": lambda: M.make_prefill_step(cfg, mesh)(
            params(), batch(False)),
        "decode": lambda: M.make_serve_step(cfg, mesh)(
            params(rules), cache, tokens(si.B), si.S_MAX - 1)}
    out = {}
    for name, step in steps.items():
        with torch.no_grad() if name != "train" else torch.enable_grad(), \
                StepCounter() as c:
            step()
        out[name] = {"collective_bytes": c.collective_bytes,
                     "flops": c.flops}
    return out


def smoke():
    import _sharded_inputs as si
    from repro_torch.compat import fake_process_group
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import StepCounter
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import model as M
    from repro_torch.sharding.dtensor import distribute
    out = {"loop_counts": {}}
    with fake_process_group(si.MESH[0] * si.MESH[1]):
        mesh = Mesh(si.MESH, ("data", "model"), torch.device("meta"),
                    device_type="cuda")
        for arch in si.ARCHS + RECURRENT + (VISION,):
            cfg = _cut(dataclasses.replace(get_config(arch, smoke=True),
                                           dtype="float32"))
            params = M.abstract_params(cfg, mesh)
            batch = {"tokens": distribute(
                torch.empty(si.B, si.S, dtype=torch.int32, device="meta"),
                mesh, (("data",), None))}
            if cfg.xattn_period:
                batch["images"] = distribute(
                    torch.empty(si.B, cfg.n_img_tokens, cfg.d_model,
                                device="meta"), mesh, (("data",), None, None))
            with StepCounter() as c:
                M.make_prefill_step(cfg, mesh)(params, batch)
            out[arch] = c.collective_bytes
        for arch in RECURRENT:
            cfg = dataclasses.replace(get_config(arch, smoke=True),
                                      dtype="float32")
            out["loop_counts"][arch] = {
                kind: _step_counts(cfg, torch.device(dev))
                for kind, dev in (("fold", "meta"), ("loop", "cpu"))}
    return out


def vision():
    from repro_torch.compat import fake_process_group
    from repro_torch.configs import get_config
    import _sharded_inputs as si
    out = {}
    with fake_process_group(si.MESH[0] * si.MESH[1]):
        for n in VISION_TOKENS:
            cfg = dataclasses.replace(get_config(VISION, smoke=True),
                                      dtype="float32", n_img_tokens=n)
            out[str(n)] = {kind: _step_counts(cfg, torch.device(dev))
                           for kind, dev in (("fold", "meta"),
                                             ("loop", "cpu"))}
    return out


def forward():
    import _sharded_inputs as si
    from repro_torch.compat import fake_process_group
    from repro_torch.configs import get_config, list_archs
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import model as M
    out = {}
    with fake_process_group(si.MESH[0] * si.MESH[1]):
        mesh = Mesh(si.MESH, ("data", "model"), torch.device("meta"),
                    device_type="cuda")
        for arch in list_archs():
            cfg = dataclasses.replace(get_config(arch, smoke=True),
                                      dtype="float32")
            batch = shard_batch(si.draw_batch(
                cfg.vocab, cfg.d_model, cfg.enc_dec,
                cfg.n_img_tokens if cfg.xattn_period else 0), mesh,
                torch.float32)
            try:
                with torch.no_grad():
                    logits = M.forward(M.abstract_params(cfg, mesh), cfg,
                                       batch, mesh)[0]
                out[arch] = [type(logits).__name__, list(logits.shape)]
            except Exception as e:  # noqa: BLE001
                out[arch] = [type(e).__name__, str(e)]
    return out


def main(argv):
    what, path = argv
    res = {"shapes": shapes, "toy": toy, "smoke": smoke,
           "vision": vision, "forward": forward}[what]()
    with open(path, "w") as f:
        json.dump(res, f)
    print("FAKE_COUNTS_OK", len(res))


if __name__ == "__main__":
    main(sys.argv[1:])
