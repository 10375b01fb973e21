"""The JAX package's partitioned LLM step on a (2, 4) mesh of 8 host
devices, for tests/test_torch_sharded_*.py.

    python tests/_jax_sharded_step.py OUT_DIR ARCH [ARCH ...] [--img-tokens N]

In a process of its own (8 placeholder host devices, as
tests/distributed_worker.py forces). For each ARCH, the smoke config in
float32 (with N image tokens where given: the cross-attention-period
stack's memory length) with tests/_sharded_inputs.py's weights and
batch, every step
under jax.jit with the specs' NamedShardings on the (data 2, model 4)
mesh: forward and loss_fn, one make_train_step step, the prefill step
and DECODE_STEPS greedy decode steps under the serving rules from a
cache whose first `history` slots are drawn; also loss_fn's gradients.
And the prefill step of the config cut to one layer of each kind (the
HLO text holds a scanned layer's body once): its compiled HLO's
collective bytes per device by kind (repro.launch.dryrun.
collective_bytes) and, for an MoE arch, those of the all-to-alls of the
MoE shard_map's (E / 4, capacity, D) buffers. For an RG-LRU stack also
`_ring_local_decode` of its first superblock's attention layer over
RING_STEPS positions of a zero ring whose slot positions start at 0 and
at -1 (F5). Writes OUT_DIR/<arch>.npz (host values: a replicated output
is device 0's) and prints JAX_SHARDED_OK.
"""
import dataclasses
import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.dirname(__file__))

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

import _sharded_inputs as si  # noqa: E402
from repro.compat import set_mesh  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import model as M  # noqa: E402
from repro.sharding.rules import serving_rules  # noqa: E402
from repro.train import optim  # noqa: E402


def _key(k):
    return str(k.key) if hasattr(k, "key") else str(k.idx)


def flat(tree, prefix):
    return {prefix + "/" + "/".join(_key(k) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def schema_leaves(schema):
    pairs = jax.tree_util.tree_flatten_with_path(
        schema, is_leaf=lambda x: isinstance(x, M.PSpec))[0]
    return [(tuple(_key(k) for k in path), ps) for path, ps in pairs]


def unflatten(schema, values):
    pairs, treedef = jax.tree_util.tree_flatten_with_path(
        schema, is_leaf=lambda x: isinstance(x, M.PSpec))
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(values[tuple(_key(k) for k in path)])
                  for path, _ in pairs])


def cut_config(cfg):
    """`cfg` cut to one layer of each kind (one dense layer; an MoE arch's
    leading dense layers and one MoE layer; an RG-LRU stack's superblock
    and a tail layer; a cross-attention-period stack's superblock)."""
    if cfg.xattn_period:
        return dataclasses.replace(cfg, n_layers=cfg.xattn_period + 1)
    if cfg.rglru:
        pattern = cfg.block_pattern or ("rglru", "rglru", "attn")
        return dataclasses.replace(cfg, n_layers=len(pattern) + 1)
    return dataclasses.replace(cfg, n_layers=cfg.first_k_dense + 1)


def ring_runs(cfg, params):
    """The ring-decode (F5) outputs: _ring_local_decode of the first
    superblock's attention layer over RING_STEPS positions of a zero ring
    of S_MAX slots whose positions start at `init` (0 and -1)."""
    layer = jax.tree.map(lambda a: a[0], params["superblocks"])
    i = (cfg.block_pattern or ("rglru", "rglru", "attn")).index("attn")
    bp = layer[f"l{i}_attn"]
    ring = jax.jit(M._ring_local_decode, static_argnums=2)
    shape = (si.B, max(cfg.n_kv_heads, 1), si.S_MAX, cfg.resolved_head_dim)
    out = {}
    for init in (0, -1):
        kc = vc = jnp.zeros(shape, jnp.float32)
        kp = jnp.full((si.S_MAX,), init, jnp.int32)
        for pos, x in enumerate(si.draw_ring(cfg.d_model)):
            o, kc, vc, kp = ring(jnp.asarray(x), bp, cfg, kc, vc, kp,
                                 jnp.int32(pos))
            out[f"ring/{init}/out/{pos}"] = o
        out.update({f"ring/{init}/k": kc, f"ring/{init}/v": vc,
                    f"ring/{init}/pos": kp})
    return out


def cut_prefill_counts(cfg, mesh, pbatch, bspec):
    """The collective bytes of the prefill step of `cfg` cut by
    cut_config on `mesh`: all of them by kind, and those of the MoE
    buffers' all-to-alls (0 without experts)."""
    from repro.launch.dryrun import (COLLECTIVE_RE, SHAPE_RE, _shape_bytes,
                                     collective_bytes)
    cut = cut_config(cfg)
    schema = M.param_schema(cut)
    params = unflatten(schema, si.draw_params(
        [(p, ps.shape, ps.scale) for p, ps in schema_leaves(schema)]))
    txt = jax.jit(M.make_prefill_step(cut, mesh),
                  in_shardings=(M.param_specs(cut, mesh),
                                {k: bspec[k] for k in pbatch})).lower(
        params, pbatch).compile().as_text()
    moe = 0
    if cut.n_experts:
        t_local = si.B * si.S // (si.MESH[0] * si.MESH[1])
        cap = max(int(t_local * cut.top_k * cut.capacity_factor
                      / cut.n_experts), 4)
        buf = f"{cut.n_experts // si.MESH[1]},{cap},{cut.d_model}"
        moe = sum(_shape_bytes(t) for t, kind in COLLECTIVE_RE.findall(txt)
                  if kind == "all-to-all"
                  and all(d == buf for _, d in SHAPE_RE.findall(t)))
    return {"cut_collective_bytes": np.array(json.dumps(
                collective_bytes(txt))),
            "cut_moe_all_to_all": np.array(moe)}


def run(arch, out_dir, img_tokens=None):
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    if img_tokens:
        cfg = dataclasses.replace(cfg, n_img_tokens=img_tokens)
    mesh = make_host_mesh(*si.MESH)
    schema = M.param_schema(cfg)
    params = unflatten(schema, si.draw_params(
        [(p, ps.shape, ps.scale) for p, ps in schema_leaves(schema)]))
    batch = {k: jnp.asarray(v) for k, v in si.draw_batch(
        cfg.vocab, cfg.d_model, cfg.enc_dec,
        cfg.n_img_tokens if cfg.xattn_period else 0).items()}
    pspecs = M.param_specs(cfg, mesh)
    bspec = {k: NamedSharding(mesh, P("data", *([None] * (v.ndim - 1))))
             for k, v in batch.items()}
    out = {}
    with set_mesh(mesh):
        def fwd_loss(p, b):
            return (M.forward(p, cfg, b, mesh)[:3],
                    jax.value_and_grad(lambda q: M.loss_fn(q, cfg, b, mesh),
                                       has_aux=True)(p))
        (logits, mtp, aux), ((loss, metrics), grads) = jax.jit(
            fwd_loss, in_shardings=(pspecs, bspec))(params, batch)
        out.update(logits=logits, aux=aux, loss=loss)
        if mtp is not None:
            out["mtp"] = mtp
        out.update(flat(metrics, "metrics"))
        out.update(flat(grads, "grads"))

        ospecs = optim.adamw_state_specs(pspecs, mesh)
        opt = jax.device_put(optim.adamw_init(params), ospecs)
        step = jax.jit(M.make_train_step(cfg, mesh),
                       in_shardings=(pspecs, ospecs, bspec))
        new_p, new_o, tmetrics = step(params, opt, batch)
        out.update(flat(new_p, "new_params"))
        out.update(flat({"m": new_o["m"], "v": new_o["v"]}, "opt"))
        out.update(flat(tmetrics, "train_metrics"))

        pbatch = {k: v for k, v in batch.items() if k != "labels"}
        prefill = jax.jit(M.make_prefill_step(cfg, mesh),
                          in_shardings=(pspecs, {k: bspec[k]
                                                 for k in pbatch}))
        # imported here: repro.launch.dryrun sets XLA_FLAGS to 512 devices
        # when imported, which must come after the backend holds its 8
        from repro.launch.dryrun import collective_bytes
        compiled = prefill.lower(params, pbatch).compile()
        coll = collective_bytes(compiled.as_text())
        last, caches = compiled(params, pbatch)
        out["prefill_logits"] = last
        out.update(flat(caches, "prefill_cache"))
        out.update(cut_prefill_counts(cfg, mesh, pbatch, bspec))

        rules = serving_rules()
        dspecs = M.param_specs(cfg, mesh, rules)
        cschema = M.cache_schema(cfg, si.B, si.S_MAX)
        first = si.history(cfg.rglru)
        cvals = si.draw_cache([(p, ps.shape, ps.logical)
                               for p, ps in schema_leaves(cschema)], first)
        cspecs = M.cache_specs(cfg, mesh, si.B, si.S_MAX, rules)
        cache = jax.device_put(unflatten(cschema, cvals), cspecs)
        tspec = NamedSharding(mesh, P("data"))
        decode = jax.jit(
            lambda p, c, t, pos: M.decode_forward(p, cfg, c, t, pos, mesh),
            in_shardings=(dspecs, cspecs, tspec, None),
            out_shardings=(tspec, cspecs))
        tok = jnp.asarray(si.first_tokens(cfg.vocab))
        for i in range(si.DECODE_STEPS):
            lg, cache = decode(params, cache, tok,
                               jnp.int32(first + i))
            tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
            out[f"decode_logits/{i}"] = lg
            out[f"decode_tokens/{i}"] = tok
        out.update(flat(cache, "decode_cache"))
    if cfg.rglru:
        out.update(ring_runs(cfg, params))
    out = {k: np.asarray(v) for k, v in out.items()}
    out["prefill_collective_bytes"] = np.array(json.dumps(coll))
    np.savez(os.path.join(out_dir, f"{arch}.npz"), **out)


def main(argv):
    img_tokens = None
    if "--img-tokens" in argv:
        i = argv.index("--img-tokens")
        img_tokens = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    out_dir, archs = argv[0], argv[1:]
    assert len(jax.devices()) == 8, jax.devices()
    for arch in archs:
        run(arch, out_dir, img_tokens)
    print("JAX_SHARDED_OK")


if __name__ == "__main__":
    main(sys.argv[1:])
