"""ArchConfig-driven model assembly: parameter schemas (with logical
sharding axes kept as data), random init, the train/prefill forward, the
loss and the AdamW train step on autograd, decode caches and the
one-token decode step for every assigned architecture family.

The PyTorch counterpart of ``repro.models.model``. The parameter and
cache trees are the reference's: the same nested keys and shapes, with
layers stacked on axis 0. Where the reference scans over the stacked
layers, this module loops over them: decode works on views of one layer
(`_layer`), so a cache is updated in place; the forward takes every
layer's views from one unbind a leaf (`_layers`), so the backward pass
writes a stacked leaf's gradient once, the layers' gradients side by
side, as the reference's scan does. The reference's `jax.checkpoint`
(its "full" remat policy) is `torch.utils.checkpoint` on the same block
bodies: a block's activations are recomputed in the backward pass.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.context import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import recurrent as rec
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (apply_rope, cross_attention, rmsnorm,
                                       rope_angles, swiglu)
from repro_torch.sharding.rules import default_rules, spec_for_shape

F32 = torch.float32


def dtype_of(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# trees: nested dicts, visited in sorted key order (jax.tree's order)
# ---------------------------------------------------------------------------

def tree_map(f: Callable, tree):
    if isinstance(tree, dict):
        return {k: tree_map(f, tree[k]) for k in sorted(tree)}
    return f(tree)


def tree_items(tree, prefix: Tuple[str, ...] = ()) -> Iterator:
    """(path, leaf) pairs in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def tree_unflatten(paths, leaves):
    """The nested-dict tree with `leaves` at `paths` (tree_items order)."""
    out: Dict[str, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def _layer(tree, i: int):
    """Views of layer i of a stacked subtree."""
    return tree_map(lambda t: t[i], tree)


def _layers(tree):
    """The per-layer views of a stacked subtree, every leaf unbound once."""
    parts = tree_map(torch.unbind, tree)
    n = len(next(tree_items(parts))[1])
    return [tree_map(lambda ts: ts[i], parts) for i in range(n)]


# ---------------------------------------------------------------------------
# parameter schema
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    scale: float = 0.02


def _dense_mlp_schema(cfg, d_ff):
    d = cfg.d_model
    return {
        "w_gate": PSpec((d, d_ff), ("embed", "mlp")),
        "w_up": PSpec((d, d_ff), ("embed", "mlp")),
        "w_down": PSpec((d_ff, d), ("mlp", "embed")),
    }


def _gqa_schema(cfg):
    d, h, hkv, dh = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
    s = {
        "wq": PSpec((d, h, dh), ("embed", "heads", "head_dim")),
        "wk": PSpec((d, hkv, dh), ("embed", "kv_heads", "head_dim")),
        "wv": PSpec((d, hkv, dh), ("embed", "kv_heads", "head_dim")),
        "wo": PSpec((h * dh, d), ("mlp", "embed")),
    }
    if cfg.qk_norm:
        s["q_norm"] = PSpec((dh,), ("embed_repl",), 1.0)
        s["k_norm"] = PSpec((dh,), ("embed_repl",), 1.0)
    return s


def _mla_schema(cfg):
    d, h = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq_a": PSpec((d, cfg.q_lora_rank), ("embed", "q_lora")),
        "q_norm": PSpec((cfg.q_lora_rank,), ("embed_repl",), 1.0),
        "wq_b": PSpec((cfg.q_lora_rank, h, dn + dr),
                      (None, "heads", "head_dim")),
        "wkv_a": PSpec((d, cfg.kv_lora_rank + dr), ("embed", None)),
        "kv_norm": PSpec((cfg.kv_lora_rank,), ("embed_repl",), 1.0),
        "wkv_b": PSpec((cfg.kv_lora_rank, h * (dn + dv)), (None, "mlp")),
        "wo": PSpec((h * dv, d), ("mlp", "embed")),
    }


def _moe_schema(cfg):
    d, e, fe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    s = {
        "w_router": PSpec((d, e), ("embed", None)),
        "w_gate": PSpec((e, d, fe), ("experts", "embed", None)),
        "w_up": PSpec((e, d, fe), ("experts", "embed", None)),
        "w_down": PSpec((e, fe, d), ("experts", None, "embed")),
    }
    if cfg.n_shared_experts:
        s["shared"] = _dense_mlp_schema(cfg, cfg.d_ff_expert * cfg.n_shared_experts)
    if cfg.dense_residual:
        s["dense"] = _dense_mlp_schema(cfg, cfg.d_ff)
    return s


def _rwkv_schema(cfg):
    d = cfg.d_model
    lora_r = 64
    tm = {
        **{f"mu_{n}": PSpec((d,), ("embed_repl",), 0.5)
           for n in ("r", "k", "v", "g", "w")},
        "wr": PSpec((d, d), ("embed", "mlp")),
        "wk": PSpec((d, d), ("embed", "mlp")),
        "wv": PSpec((d, d), ("embed", "mlp")),
        "wg": PSpec((d, d), ("embed", "mlp")),
        "wo": PSpec((d, d), ("mlp", "embed")),
        "w_lora_a": PSpec((d, lora_r), ("embed", None)),
        "w_lora_b": PSpec((lora_r, d), (None, "embed")),
        "w0": PSpec((d,), ("embed_repl",), 0.5),
        "u_bonus": PSpec((d,), ("embed_repl",), 0.5),
        "ln_x_w": PSpec((d,), ("embed_repl",), 1.0),
    }
    cm = {
        "mu_ck": PSpec((d,), ("embed_repl",), 0.5),
        "mu_cr": PSpec((d,), ("embed_repl",), 0.5),
        "w_key": PSpec((d, cfg.d_ff), ("embed", "mlp")),
        "w_value": PSpec((cfg.d_ff, d), ("mlp", "embed")),
        "w_recept": PSpec((d, d), ("embed", "mlp")),
    }
    return {"ln1": PSpec((d,), ("embed_repl",), 1.0), "time_mix": tm,
            "ln2": PSpec((d,), ("embed_repl",), 1.0), "channel_mix": cm}


def _rglru_schema(cfg):
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    return {
        "w_in_y": PSpec((d, w), ("embed", "mlp")),
        "w_in_g": PSpec((d, w), ("embed", "mlp")),
        "conv_w": PSpec((cfg.conv_width, w), ("conv", "mlp"), 0.1),
        "w_a": PSpec((w,), ("embed_repl",), 0.1),
        "b_a": PSpec((w,), ("embed_repl",), 0.1),
        "w_x": PSpec((w,), ("embed_repl",), 0.1),
        "b_x": PSpec((w,), ("embed_repl",), 0.1),
        "lambda_p": PSpec((w,), ("embed_repl",), 0.5),
        "w_out": PSpec((w, d), ("mlp", "embed")),
    }


def _xattn_schema(cfg):
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    hkv = max(cfg.n_kv_heads, 1)
    return {
        "wq": PSpec((d, h, dh), ("embed", "heads", "head_dim")),
        "wk": PSpec((d, hkv, dh), ("embed", "kv_heads", "head_dim")),
        "wv": PSpec((d, hkv, dh), ("embed", "kv_heads", "head_dim")),
        "wo": PSpec((h * dh, d), ("mlp", "embed")),
        "gate": PSpec((1,), ("embed_repl",), 0.0),
    }


def _block_schema(cfg, kind: str):
    d = cfg.d_model
    base = {"attn_norm": PSpec((d,), ("embed_repl",), 1.0),
            "mlp_norm": PSpec((d,), ("embed_repl",), 1.0)}
    if kind == "dense":
        base["attn"] = (_mla_schema(cfg) if cfg.attention == "mla"
                        else _gqa_schema(cfg))
        ff = 18432 if (cfg.name.startswith("deepseek")) else cfg.d_ff
        base["mlp"] = _dense_mlp_schema(cfg, ff)
    elif kind == "moe":
        base["attn"] = (_mla_schema(cfg) if cfg.attention == "mla"
                        else _gqa_schema(cfg))
        base["moe"] = _moe_schema(cfg)
    elif kind == "xattn":
        base["attn"] = _xattn_schema(cfg)
        base["mlp"] = _dense_mlp_schema(cfg, cfg.d_ff)
    elif kind == "rwkv":
        return _rwkv_schema(cfg)
    elif kind == "rglru":
        base["attn"] = _rglru_schema(cfg)
        base["mlp"] = _dense_mlp_schema(cfg, cfg.d_ff)
    elif kind == "attn":   # recurrentgemma local-attention layer
        base["attn"] = _gqa_schema(cfg)
        base["mlp"] = _dense_mlp_schema(cfg, cfg.d_ff)
    else:
        raise ValueError(kind)
    return base


def _stack(schema, n: int):
    """Add a leading layer axis to every PSpec in a schema subtree."""
    return tree_map(
        lambda ps: PSpec((n,) + ps.shape, ("layers",) + ps.logical, ps.scale),
        schema)


def param_schema(cfg: ArchConfig) -> Dict[str, Any]:
    d, v = cfg.d_model, cfg.vocab
    s: Dict[str, Any] = {
        "embed": PSpec((v, d), ("vocab", "embed")),
        "final_norm": PSpec((d,), ("embed_repl",), 1.0),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = PSpec((d, v), ("embed", "vocab"))
    if cfg.enc_dec:
        s["enc_blocks"] = _stack(_block_schema(cfg, "dense"), cfg.n_enc_layers)
        dec = _block_schema(cfg, "dense")
        dec["xattn"] = _xattn_schema(cfg)
        dec["xattn_norm"] = PSpec((d,), ("embed_repl",), 1.0)
        s["dec_blocks"] = _stack(dec, cfg.n_layers)
        s["enc_final_norm"] = PSpec((d,), ("embed_repl",), 1.0)
    elif cfg.xattn_period:
        n_super = cfg.n_layers // (cfg.xattn_period + 1)
        sb = {"self": _stack(_block_schema(cfg, "dense"), cfg.xattn_period),
              "cross": _block_schema(cfg, "xattn")}
        s["superblocks"] = _stack(sb, n_super)
    elif cfg.rwkv:
        s["blocks"] = _stack(_block_schema(cfg, "rwkv"), cfg.n_layers)
    elif cfg.rglru:
        pat = cfg.block_pattern or ("rglru", "rglru", "attn")
        n_super = cfg.n_layers // len(pat)
        tail = cfg.n_layers - n_super * len(pat)
        sb = {f"l{i}_{k}": _block_schema(cfg, k) for i, k in enumerate(pat)}
        s["superblocks"] = _stack(sb, n_super)
        for i in range(tail):
            s[f"tail_{i}"] = _block_schema(cfg, pat[i])
    elif cfg.n_experts:
        if cfg.first_k_dense:
            s["dense_blocks"] = _stack(_block_schema(cfg, "dense"),
                                       cfg.first_k_dense)
        s["moe_blocks"] = _stack(_block_schema(cfg, "moe"),
                                 cfg.n_layers - cfg.first_k_dense)
    else:
        s["blocks"] = _stack(_block_schema(cfg, "dense"), cfg.n_layers)
    if cfg.mtp:
        s["mtp_block"] = _block_schema(cfg, "dense")
        s["mtp_norm"] = PSpec((d,), ("embed_repl",), 1.0)
    return s


def param_count(cfg: ArchConfig) -> int:
    """Elements of every leaf of the parameter schema (shapes only)."""
    return sum(math.prod(ps.shape) for _, ps in tree_items(param_schema(cfg)))


def init_params(cfg: ArchConfig, generator: torch.Generator, device=None):
    """Concrete random init on `device` (the generator's by default): norm
    weights (scale 1.0, at most two axes) are ones, every other leaf a
    standard normal times its scale, in cfg.dtype. Leaves are drawn in
    sorted key order from `generator`."""
    device = torch.device(device if device is not None else generator.device)
    dt = dtype_of(cfg)

    def draw(ps: PSpec):
        if ps.scale == 1.0 and len(ps.shape) <= 2:   # norm weights
            return torch.ones(ps.shape, dtype=dt, device=device)
        return torch.randn(ps.shape, generator=generator, dtype=dt,
                           device=device).mul_(ps.scale)
    return tree_map(draw, param_schema(cfg))


def abstract_params(cfg: ArchConfig):
    """The parameter tree's shapes and dtype as meta tensors (the
    reference's ShapeDtypeStructs): nothing is allocated."""
    dt = dtype_of(cfg)
    return tree_map(lambda ps: torch.empty(ps.shape, dtype=dt, device="meta"),
                    param_schema(cfg))


def logical_axes(cfg: ArchConfig):
    return tree_map(lambda ps: ps.logical, param_schema(cfg))


def _specs(schema, mesh, rules):
    rules = rules or default_rules()
    return tree_map(lambda ps: spec_for_shape(mesh, ps.logical, ps.shape,
                                              rules), schema)


def param_specs(cfg: ArchConfig, mesh, rules=None):
    """The parameter tree's specs on `mesh` (sharding.rules' tuples; the
    reference returns NamedShardings of the same PartitionSpecs)."""
    return _specs(param_schema(cfg), mesh, rules)


def tensor_from_numpy(a) -> torch.Tensor:
    """A numpy array (ml_dtypes' bfloat16 included) as a CPU tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.uint16).copy()).view(
                torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_jax(tree, device):
    """The reference's init_params tree, given as numpy arrays, as the
    port's parameter tree on `device`. The two trees have the same keys
    and shapes, so the copy is leaf-wise."""
    return tree_map(lambda a: tensor_from_numpy(a).to(device), tree)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _mlp(x, bp, cfg):
    h = rmsnorm(x, bp["mlp_norm"], cfg.norm_eps)
    m = bp["mlp"]
    return x + swiglu(h, m["w_gate"], m["w_up"], m["w_down"])


def _self_attn(x, bp, cfg, positions):
    h = rmsnorm(x, bp["attn_norm"], cfg.norm_eps)
    if cfg.attention == "mla":
        o, kv = attn.mla_forward(h, bp["attn"], cfg, positions)
    else:
        o, kv = attn.gqa_forward(h, bp["attn"], cfg, positions)
    return x + o, kv


def _moe_layer(x, bp, cfg, mesh, variant="auto"):
    """x (B,S,D) -> (B,S,D), aux. "auto" chooses all_to_all when the
    tokens split evenly over the data-parallel and model ranks with at
    least 8 a rank, else the psum schedule (the reference's rule);
    decode asks for "psum", which needs no mesh (None). The port runs the
    model on one rank: every expert and every token is on it. The mesh is
    a launch.mesh.Mesh of one rank, or a compat.AbstractMesh of one (the
    dry run's count on meta tensors), whose all_to_all keeps its blocks:
    both run the all_to_all schedule, so they count the same matmuls."""
    b, s, d = x.shape
    h = rmsnorm(x, bp["mlp_norm"], cfg.norm_eps)
    tokens = h.reshape(b * s, d)
    m = bp["moe"]
    experts = {k: m[k] for k in ("w_router", "w_gate", "w_up", "w_down")}
    ranks = 1
    if mesh is not None:
        ranks = math.prod(mesh.shape.values())
        if ranks != 1:
            raise ValueError(f"the MoE layer runs on one rank; the mesh "
                             f"{mesh.shape} has {ranks}")
    use_a2a = (variant == "a2a" or
               (variant == "auto" and (b * s) % ranks == 0
                and (b * s) // ranks >= 8))
    if use_a2a:
        out, aux = moe_mod.moe_all_to_all(tokens, experts, cfg, mesh)
    else:
        out, aux = moe_mod.moe_psum(tokens, experts, cfg)
    out = out.reshape(b, s, d)
    if cfg.n_shared_experts:
        sh = m["shared"]
        out = out + swiglu(h, sh["w_gate"], sh["w_up"], sh["w_down"])
    if cfg.dense_residual:
        dn = m["dense"]
        out = out + swiglu(h, dn["w_gate"], dn["w_up"], dn["w_down"])
    return x + out, aux


# ---------------------------------------------------------------------------
# forward (training / prefill)
# ---------------------------------------------------------------------------

def _remat(f):
    """The reference's jax.checkpoint ("full"): keep only the block's
    inputs and recompute its activations in the backward pass."""
    return lambda *args: checkpoint(f, *args, use_reentrant=False)


def _scan(f, x, stacked):
    """x through f(x, layer) for every layer of a stacked subtree; the
    per-layer outputs in a list."""
    outs = []
    for bp in _layers(stacked):
        x, o = f(x, bp)
        outs.append(o)
    return x, outs


def _stack_outs(outs):
    """A list of per-layer outputs (tensors, tuples of them, or None)
    stacked on a new leading axis, as the reference's scan returns them."""
    first = outs[0] if outs else None
    if first is None:
        return None
    if isinstance(first, tuple):
        return tuple(_stack_outs([o[i] for o in outs])
                     for i in range(len(first)))
    return torch.stack(outs)


def forward(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor], mesh,
            collect_cache: bool = False):
    """Returns (logits, mtp_logits, aux_loss, cache_or_None).

    batch: tokens (B,S) [+ images (B,Timg,D) | frames (B,Senc,D)]. `mesh`
    (a launch.mesh.Mesh of one rank) carries the MoE layers' all_to_all.
    """
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = F.embedding(tokens, params["embed"]).to(dtype_of(cfg))
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    aux_total = torch.zeros((), dtype=F32, device=x.device)
    caches: Dict[str, Any] = {}

    def dense_block(h, bp):
        h, kv = _self_attn(h, bp, cfg, positions)
        return _mlp(h, bp, cfg), kv

    if cfg.enc_dec:
        frames = batch["frames"].to(x.dtype)
        enc_pos = torch.arange(frames.shape[1], dtype=torch.int32,
                               device=x.device).expand(frames.shape[:2])

        def enc_block(h, bp):
            hn = rmsnorm(h, bp["attn_norm"], cfg.norm_eps)
            o, _ = attn.gqa_forward(hn, bp["attn"], cfg, enc_pos)
            return _mlp(h + o, bp, cfg), None

        enc_x, _ = _scan(_remat(enc_block), frames, params["enc_blocks"])
        memory = rmsnorm(enc_x, params["enc_final_norm"], cfg.norm_eps)

        def dec_block(h, bp):
            h, kv = _self_attn(h, bp, cfg, positions)
            hx = rmsnorm(h, bp["xattn_norm"], cfg.norm_eps)
            g = torch.tanh(bp["xattn"]["gate"].to(F32)).to(h.dtype)
            h = h + g * cross_attention(hx, memory, bp["xattn"], cfg)
            return _mlp(h, bp, cfg), kv

        x, kvs = _scan(_remat(dec_block), x, params["dec_blocks"])
        if collect_cache:
            caches = {"self_kv": _stack_outs(kvs), "memory": memory}

    elif cfg.xattn_period:
        images = batch["images"].to(x.dtype)

        def superblock(h, sbp):
            h, kvs = _scan(_remat(dense_block), h, sbp["self"])
            cb = sbp["cross"]
            hn = rmsnorm(h, cb["attn_norm"], cfg.norm_eps)
            g = torch.tanh(cb["attn"]["gate"].to(F32)).to(h.dtype)
            h = h + g * cross_attention(hn, images, cb["attn"], cfg)
            h = h + swiglu(rmsnorm(h, cb["mlp_norm"], cfg.norm_eps),
                           cb["mlp"]["w_gate"], cb["mlp"]["w_up"],
                           cb["mlp"]["w_down"])
            return h, kvs

        x, kvs = _scan(superblock, x, params["superblocks"])
        if collect_cache:
            caches = {"self_kv": _stack_outs([_stack_outs(k) for k in kvs]),
                      "images": images}

    elif cfg.rwkv:
        def rwkv_block(h, bp):
            o, (st, xl) = rec.rwkv_time_mix(
                rmsnorm(h, bp["ln1"], cfg.norm_eps), bp["time_mix"], cfg)
            h = h + o
            o, xl2 = rec.rwkv_channel_mix(
                rmsnorm(h, bp["ln2"], cfg.norm_eps), bp["channel_mix"], cfg)
            return h + o, (st, xl, xl2)

        x, states = _scan(_remat(rwkv_block), x, params["blocks"])
        if collect_cache:
            caches = {"states": _stack_outs(states)}

    elif cfg.rglru:
        pat = cfg.block_pattern or ("rglru", "rglru", "attn")

        def one_layer(h, bp, kind):
            if kind == "rglru":
                hn = rmsnorm(h, bp["attn_norm"], cfg.norm_eps)
                o, st = rec.rglru_block(hn, bp["attn"], cfg)
                return _mlp(h + o, bp, cfg), st
            h, kv = _self_attn(h, bp, cfg, positions)
            return _mlp(h, bp, cfg), kv

        def superblock(h, sbp):
            sts = []
            for i, kind in enumerate(pat):
                h, st = _remat(lambda hh, bp, kind=kind: one_layer(
                    hh, bp, kind))(h, sbp[f"l{i}_{kind}"])
                sts.append(st)
            return h, tuple(sts)

        x, states = _scan(superblock, x, params["superblocks"])
        tail_states = []
        n_super = cfg.n_layers // len(pat)
        for i in range(cfg.n_layers - n_super * len(pat)):
            x, st = one_layer(x, params[f"tail_{i}"], pat[i])
            tail_states.append(st)
        if collect_cache:
            caches = {"states": _stack_outs(states),
                      "tail_states": tuple(tail_states)}

    elif cfg.n_experts:
        kv_dense = None
        if cfg.first_k_dense:
            x, kv_dense = _scan(_remat(dense_block), x,
                                params["dense_blocks"])

        def moe_block(h, bp):
            h, kv = _self_attn(h, bp, cfg, positions)
            h, aux = _moe_layer(h, bp, cfg, mesh)
            return h, (kv, aux)

        x, outs = _scan(_remat(moe_block), x, params["moe_blocks"])
        aux_total = aux_total + torch.sum(torch.stack([a for _, a in outs]))
        if collect_cache:
            caches = {"kv_dense": (_stack_outs(kv_dense)
                                   if kv_dense is not None else None),
                      "kv_moe": _stack_outs([kv for kv, _ in outs])}

    else:
        x, kvs = _scan(_remat(dense_block), x, params["blocks"])
        if collect_cache:
            caches = {"kv": _stack_outs(kvs)}

    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"])
    logits = torch.einsum("bsd,dv->bsv", x, head)

    mtp_logits = None
    if cfg.mtp:
        h2 = rmsnorm(x, params["mtp_norm"], cfg.norm_eps)
        h2, _ = _self_attn(h2, params["mtp_block"], cfg, positions)
        h2 = _mlp(h2, params["mtp_block"], cfg)
        mtp_logits = torch.einsum("bsd,dv->bsv", h2, head)

    return logits, mtp_logits, aux_total, (caches if collect_cache else None)


# ---------------------------------------------------------------------------
# losses / train step
# ---------------------------------------------------------------------------

def _ce(logits, labels):
    """CE without materializing (B,S,V) f32 log-probs: gather the label
    logit first, reduce the logsumexp in f32 on the fly."""
    label_logit = torch.gather(logits, -1, labels[..., None].long())[
        ..., 0].to(F32)
    m = logits.amax(-1).to(F32)
    lse = m + torch.log(torch.sum(torch.exp(logits.to(F32) - m[..., None]),
                                  dim=-1))
    return torch.mean(lse - label_logit)


def loss_fn(params, cfg: ArchConfig, batch, mesh):
    logits, mtp_logits, aux, _ = forward(params, cfg, batch, mesh)
    labels = batch["labels"]
    loss = _ce(logits, labels)
    metrics = {"ce": loss}
    if cfg.n_experts:
        loss = loss + cfg.router_aux_weight * aux
        metrics["aux"] = aux
    if cfg.mtp and mtp_logits is not None:
        # MTP head predicts token t+2: shift labels one extra step left
        mtp_labels = torch.cat([labels[:, 1:], labels[:, -1:]], dim=1)
        mtp_loss = _ce(mtp_logits[:, :-1], mtp_labels[:, :-1])
        loss = loss + 0.3 * mtp_loss
        metrics["mtp_ce"] = mtp_loss
    metrics["loss"] = loss
    return loss, metrics


def make_train_step(cfg: ArchConfig, mesh, learning_rate: float = 3e-4,
                    weight_decay: float = 0.1, grad_clip: float = 1.0):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics): the gradient of loss_fn over every parameter leaf, clipped
    by global norm, then train.optim's AdamW. The parameters and the
    optimizer state are updated in place and returned, so a step holds
    one copy of them."""
    from repro_torch.train.optim import adamw_update, clip_by_global_norm

    def train_step(params, opt_state, batch):
        paths = [path for path, _ in tree_items(params)]
        leaves = [t.detach().requires_grad_() for _, t in tree_items(params)]
        with torch.enable_grad():
            loss, metrics = loss_fn(tree_unflatten(paths, leaves), cfg, batch,
                                    mesh)
            grads = torch.autograd.grad(loss, leaves)
        del leaves, loss
        grads, gnorm = clip_by_global_norm(tree_unflatten(paths, grads),
                                           grad_clip)
        params, opt_state = adamw_update(params, grads, opt_state,
                                         lr=learning_rate, wd=weight_decay)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = gnorm
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig, mesh):
    def prefill_step(params, batch):
        logits, _, _, caches = forward(params, cfg, batch, mesh,
                                       collect_cache=True)
        return logits[:, -1], caches
    return prefill_step


# ---------------------------------------------------------------------------
# caches (decode state) — schemas + zero init
# ---------------------------------------------------------------------------

def cache_schema(cfg: ArchConfig, batch: int, s_max: int) -> Dict[str, Any]:
    """Tree of PSpec describing the decode cache."""
    hkv, dh = max(cfg.n_kv_heads, 1), cfg.resolved_head_dim
    kv_axes = ("layers", "batch", "kv_heads", "seq", "head_dim")

    def kv(n_layers, s=s_max):
        return {"k": PSpec((n_layers, batch, hkv, s, dh), kv_axes),
                "v": PSpec((n_layers, batch, hkv, s, dh), kv_axes)}

    if cfg.attention == "mla":
        lat = cfg.kv_lora_rank + cfg.qk_rope_head_dim
        mla_axes = ("layers", "batch", "seq", None)
        out = {}
        if cfg.first_k_dense:
            out["dense"] = PSpec((cfg.first_k_dense, batch, s_max, lat),
                                 mla_axes)
        out["moe"] = PSpec((cfg.n_layers - cfg.first_k_dense, batch, s_max,
                            lat), mla_axes)
        return out
    if cfg.enc_dec:
        return {"self": kv(cfg.n_layers),
                "memory": PSpec((batch, 4096, cfg.d_model),
                                ("batch", "seq", "embed_repl"))}
    if cfg.xattn_period:
        n_super = cfg.n_layers // (cfg.xattn_period + 1)
        return {"self": {"k": PSpec((n_super, cfg.xattn_period, batch, hkv,
                                     s_max, dh), ("layers",) + kv_axes),
                         "v": PSpec((n_super, cfg.xattn_period, batch, hkv,
                                     s_max, dh), ("layers",) + kv_axes)},
                "images": PSpec((batch, cfg.n_img_tokens, cfg.d_model),
                                ("batch", "seq", "embed_repl"))}
    if cfg.rwkv:
        h = cfg.d_model // rec.RWKV_HEAD_DIM
        return {"wkv": PSpec((cfg.n_layers, batch, h, rec.RWKV_HEAD_DIM,
                              rec.RWKV_HEAD_DIM),
                             ("layers", "batch", "heads", None, None)),
                "x_tm": PSpec((cfg.n_layers, batch, cfg.d_model),
                              ("layers", "batch", "embed_repl")),
                "x_cm": PSpec((cfg.n_layers, batch, cfg.d_model),
                              ("layers", "batch", "embed_repl"))}
    if cfg.rglru:
        pat = cfg.block_pattern or ("rglru", "rglru", "attn")
        n_super = cfg.n_layers // len(pat)
        w = cfg.lru_width or cfg.d_model
        window = min(cfg.local_window, s_max)
        out = {}
        for i, kind in enumerate(pat):
            if kind == "rglru":
                out[f"conv_{i}"] = PSpec(
                    (n_super, batch, cfg.conv_width - 1, w),
                    ("layers", "batch", None, "mlp"))
                out[f"lru_{i}"] = PSpec((n_super, batch, w),
                                        ("layers", "batch", "mlp"))
            else:
                out[f"k_{i}"] = PSpec((n_super, batch, hkv, window, dh),
                                      kv_axes)
                out[f"v_{i}"] = PSpec((n_super, batch, hkv, window, dh),
                                      kv_axes)
                out[f"pos_{i}"] = PSpec((n_super, window),
                                        ("layers", None))
        # tail layers (pattern prefix)
        tail = cfg.n_layers - n_super * len(pat)
        for i in range(tail):
            if pat[i] == "rglru":
                out[f"tconv_{i}"] = PSpec((batch, cfg.conv_width - 1, w),
                                          ("batch", None, "mlp"))
                out[f"tlru_{i}"] = PSpec((batch, w), ("batch", "mlp"))
            else:
                out[f"tk_{i}"] = PSpec((batch, hkv, window, dh), kv_axes[1:])
                out[f"tv_{i}"] = PSpec((batch, hkv, window, dh), kv_axes[1:])
                out[f"tpos_{i}"] = PSpec((window,), (None,))
        return out
    return kv(cfg.n_layers)


def abstract_cache(cfg: ArchConfig, batch: int, s_max: int):
    """The cache's shapes and dtypes as meta tensors: the ring positions
    (top-level `pos_*`/`tpos_*`) are int32, every other leaf cfg.dtype."""
    dt = dtype_of(cfg)

    def meta(ps: PSpec, d=dt):
        return torch.empty(ps.shape, dtype=d, device="meta")
    out = {}
    for k, v in cache_schema(cfg, batch, s_max).items():
        if isinstance(v, PSpec):
            out[k] = meta(v, torch.int32 if k.startswith(("pos", "tpos"))
                          else dt)
        else:
            out[k] = tree_map(meta, v)
    return out


def cache_specs(cfg: ArchConfig, mesh, batch: int, s_max: int, rules=None):
    return _specs(cache_schema(cfg, batch, s_max), mesh, rules)


def init_cache(cfg: ArchConfig, batch: int, s_max: int, device):
    return tree_map(lambda m: torch.zeros(m.shape, dtype=m.dtype,
                                          device=device),
                    abstract_cache(cfg, batch, s_max))


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------

def _ring_local_decode(x, bp, cfg, k_cache, v_cache, kv_pos, pos):
    """Sliding-window decode with a ring-buffer cache (window-sized),
    updated in place. As in the reference, slots never written hold
    position 0 and count as valid (ROADMAP §3, F5)."""
    b = x.shape[0]
    h, hkv, dh = cfg.n_heads, max(cfg.n_kv_heads, 1), cfg.resolved_head_dim
    hn = rmsnorm(x, bp["attn_norm"], cfg.norm_eps)
    p = bp["attn"]
    q = torch.einsum("bsd,dhk->bshk", hn, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", hn, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", hn, p["wv"])
    positions = torch.full((b, 1), int(pos), dtype=torch.int32,
                           device=x.device)
    cos, sin = rope_angles(positions, dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin).transpose(1, 2)
    k = apply_rope(k, cos, sin).transpose(1, 2)
    v = v.transpose(1, 2)
    window = k_cache.shape[2]
    slot = int(pos) % window
    k_cache[:, :, slot] = k[:, :, 0]
    v_cache[:, :, slot] = v[:, :, 0]
    kv_pos[slot] = int(pos)
    g, hg = hkv, h // hkv
    qg = q.reshape(b, g, hg, 1, dh)
    s = torch.einsum("bghqd,bgkd->bghqk", qg, k_cache).to(F32)
    s = s / math.sqrt(dh)
    valid = (kv_pos <= pos) & (pos - kv_pos < window) & (kv_pos >= 0)
    s = torch.where(valid, s, -1e30)
    pattn = torch.softmax(s, dim=-1)
    o = torch.einsum("bghqk,bgkd->bghqd", pattn.to(v_cache.dtype), v_cache)
    o = o.reshape(b, h, 1, dh).transpose(1, 2).reshape(b, 1, h * dh)
    x = x + torch.einsum("bse,ed->bsd", o, p["wo"])
    return _mlp(x, bp, cfg), k_cache, v_cache, kv_pos


def _rglru_layer(x, bp, cfg, conv_st, lru_st):
    """One recurrent layer of recurrentgemma; the lru state is stored in
    cfg.dtype and lifted to float32 for the step."""
    hn = rmsnorm(x, bp["attn_norm"], cfg.norm_eps)
    o, (conv_st, lru) = rec.rglru_block(hn, bp["attn"], cfg,
                                        state=(conv_st, lru_st.to(F32)))
    return _mlp(x + o, bp, cfg), conv_st, lru.to(lru_st.dtype)


def decode_forward(params, cfg: ArchConfig, cache, tokens, pos):
    """One decode step. tokens (B,) int; pos: int (current index).
    Returns (logits (B,V), cache): the cache's tensors are updated in
    place, and the returned tree is the one passed in."""
    pos = int(pos)
    x = params["embed"][tokens][:, None, :].to(dtype_of(cfg))

    def dense_decode(h, bp, kc, vc):
        hn = rmsnorm(h, bp["attn_norm"], cfg.norm_eps)
        o, _ = attn.gqa_decode(hn, bp["attn"], cfg, (kc, vc), pos)
        return _mlp(h + o, bp, cfg)

    if cfg.attention == "mla":
        def mla_dec(h, bp, lat):
            hn = rmsnorm(h, bp["attn_norm"], cfg.norm_eps)
            o, _ = attn.mla_decode(hn, bp["attn"], cfg, lat, pos)
            return h + o

        if cfg.first_k_dense:
            for i in range(cfg.first_k_dense):
                bp = _layer(params["dense_blocks"], i)
                x = _mlp(mla_dec(x, bp, cache["dense"][i]), bp, cfg)
        blocks_key = "moe_blocks" if cfg.n_experts else "blocks"
        for i in range(cache["moe"].shape[0]):
            bp = _layer(params[blocks_key], i)
            x = mla_dec(x, bp, cache["moe"][i])
            if cfg.n_experts:
                x, _ = _moe_layer(x, bp, cfg, None, variant="psum")
            else:
                x = _mlp(x, bp, cfg)

    elif cfg.enc_dec:
        memory = cache["memory"].to(x.dtype)
        for i in range(cfg.n_layers):
            bp = _layer(params["dec_blocks"], i)
            x = dense_decode(x, bp, cache["self"]["k"][i],
                             cache["self"]["v"][i])
            hx = rmsnorm(x, bp["xattn_norm"], cfg.norm_eps)
            g = torch.tanh(bp["xattn"]["gate"].to(F32)).to(x.dtype)
            x = x + g * cross_attention(hx, memory, bp["xattn"], cfg)

    elif cfg.xattn_period:
        images = cache["images"].to(x.dtype)
        for j in range(cache["self"]["k"].shape[0]):
            sbp = _layer(params["superblocks"], j)
            for i in range(cfg.xattn_period):
                x = dense_decode(x, _layer(sbp["self"], i),
                                 cache["self"]["k"][j, i],
                                 cache["self"]["v"][j, i])
            cb = sbp["cross"]
            hn = rmsnorm(x, cb["attn_norm"], cfg.norm_eps)
            g = torch.tanh(cb["attn"]["gate"].to(F32)).to(x.dtype)
            x = x + g * cross_attention(hn, images, cb["attn"], cfg)
            x = x + swiglu(rmsnorm(x, cb["mlp_norm"], cfg.norm_eps),
                           cb["mlp"]["w_gate"], cb["mlp"]["w_up"],
                           cb["mlp"]["w_down"])

    elif cfg.rwkv:
        for i in range(cfg.n_layers):
            bp = _layer(params["blocks"], i)
            o, (st, x_tm) = rec.rwkv_time_mix(
                rmsnorm(x, bp["ln1"], cfg.norm_eps), bp["time_mix"], cfg,
                state=cache["wkv"][i].to(F32), x_last=cache["x_tm"][i])
            x = x + o
            o, x_cm = rec.rwkv_channel_mix(
                rmsnorm(x, bp["ln2"], cfg.norm_eps), bp["channel_mix"], cfg,
                x_last=cache["x_cm"][i])
            x = x + o
            cache["wkv"][i] = st
            cache["x_tm"][i] = x_tm
            cache["x_cm"][i] = x_cm

    elif cfg.rglru:
        pat = cfg.block_pattern or ("rglru", "rglru", "attn")
        n_super = cfg.n_layers // len(pat)
        for j in range(n_super):
            sbp = _layer(params["superblocks"], j)
            for i, kind in enumerate(pat):
                bp = sbp[f"l{i}_{kind}"]
                if kind == "rglru":
                    x, conv, lru = _rglru_layer(
                        x, bp, cfg, cache[f"conv_{i}"][j],
                        cache[f"lru_{i}"][j])
                    cache[f"conv_{i}"][j] = conv
                    cache[f"lru_{i}"][j] = lru
                else:
                    x = _ring_local_decode(
                        x, bp, cfg, cache[f"k_{i}"][j], cache[f"v_{i}"][j],
                        cache[f"pos_{i}"][j], pos)[0]
        for i in range(cfg.n_layers - n_super * len(pat)):
            bp = params[f"tail_{i}"]
            if pat[i] == "rglru":
                x, conv, lru = _rglru_layer(x, bp, cfg, cache[f"tconv_{i}"],
                                            cache[f"tlru_{i}"])
                cache[f"tconv_{i}"].copy_(conv)
                cache[f"tlru_{i}"].copy_(lru)
            else:
                x = _ring_local_decode(
                    x, bp, cfg, cache[f"tk_{i}"], cache[f"tv_{i}"],
                    cache[f"tpos_{i}"], pos)[0]

    elif cfg.n_experts:   # GQA MoE (arctic)
        for i in range(cfg.n_layers):
            bp = _layer(params["moe_blocks"], i)
            hn = rmsnorm(x, bp["attn_norm"], cfg.norm_eps)
            o, _ = attn.gqa_decode(hn, bp["attn"], cfg,
                                   (cache["k"][i], cache["v"][i]), pos)
            x, _ = _moe_layer(x + o, bp, cfg, None, variant="psum")

    else:
        for i in range(cfg.n_layers):
            x = dense_decode(x, _layer(params["blocks"], i), cache["k"][i],
                             cache["v"][i])

    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = torch.einsum("bsd,dv->bsv", x[:, 0:1], head)[:, 0]
    return logits, cache


def make_serve_step(cfg: ArchConfig):
    def serve_step(params, cache, tokens, pos):
        logits, cache = decode_forward(params, cfg, cache, tokens, pos)
        next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tokens, cache
    return serve_step


class DecodeModel(nn.Module):
    """A model of one architecture for serving: its parameter tree,
    registered leaf by leaf (path joined by '__'), and its decode step.

    Weights are drawn on `device` by init_params from a generator seeded
    with 0, unless `params` (a tree on that device, e.g. from
    params_from_jax) is given. The device is CUDA unless the caller asks
    for another; asking for CUDA where there is none raises."""

    def __init__(self, cfg: ArchConfig, device=None, *, params=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            params = init_params(cfg, gen, self.device)
        self.params = tree_map(
            lambda t: nn.Parameter(t, requires_grad=False), params)
        for path, leaf in tree_items(self.params):
            self.register_parameter("__".join(path), leaf)
        self._step = make_serve_step(cfg)

    def init_cache(self, batch: int, s_max: int):
        return init_cache(self.cfg, batch, s_max, self.device)

    @torch.no_grad()
    def decode(self, cache, tokens, pos):
        """(logits (B, V), new cache) of one step."""
        return decode_forward(self.params, self.cfg, cache, tokens, pos)

    @torch.no_grad()
    def serve_step(self, cache, tokens, pos):
        """(greedy next tokens (B,) int32, new cache) of one step."""
        return self._step(self.params, cache, tokens, pos)
