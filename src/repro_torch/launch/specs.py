"""Per-(arch x shape) dry-run cells: meta-tensor inputs (shapes and
dtypes, nothing allocated), their specs and the outputs', and the step
function that runs on them.

The PyTorch counterpart of ``repro.launch.specs``. Shapes:
    train_4k     seq=4096    global_batch=256   train_step
    prefill_32k  seq=32768   global_batch=32    prefill_step
    decode_32k   seq=32768   global_batch=128   serve_step (1 new token)
    long_500k    seq=524288  global_batch=1     serve_step; sub-quadratic
                 archs only (rwkv6, recurrentgemma); full-attention archs
                 skip.

The specs are resolved on the given mesh (compat.AbstractMesh or
launch.mesh.Mesh). The step is the port's one-rank step, built on a
device-less mesh of one rank: the port executes no sharded step, so a
cell's step is the whole (unsharded) computation, and its specs say how
the reference lays that computation out over the mesh. A decode step is
given `pos` as a Python int, seq - 1 (the reference's is an abstract
int32 scalar): the decode attention masks over every cache slot, so its
matmuls do not depend on the position.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.compat import abstract_mesh
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.sharding.rules import normalize, serving_rules
from repro_torch.train.optim import abstract_adamw_state, adamw_state_specs

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}

REPLICATED = ()     # the reference's PartitionSpec()


def cell_applicable(cfg: ArchConfig, shape_name: str) -> Tuple[bool, str]:
    if shape_name == "long_500k" and not cfg.subquadratic:
        return False, ("full-attention arch: O(S^2) at 524288 is out of "
                       "scope per assignment (sub-quadratic archs only)")
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_abstract(cfg: ArchConfig, b: int, s: int, with_labels: bool):
    out = {"tokens": _meta((b, s), torch.int32)}
    if with_labels:
        out["labels"] = _meta((b, s), torch.int32)
    if cfg.xattn_period:
        out["images"] = _meta((b, cfg.n_img_tokens, cfg.d_model),
                              torch.bfloat16)
    if cfg.enc_dec:
        out["frames"] = _meta((b, s, cfg.d_model), torch.bfloat16)
    return out


def _dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _batch_specs(cfg: ArchConfig, batch_abs, mesh):
    dp = _dp_axes(mesh)
    return {k: normalize((dp,) + (None,) * (x.dim() - 1))
            for k, x in sorted(batch_abs.items())}


def _axes_prod(mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def step_mesh(mesh):
    """The one-rank device-less mesh a cell's step runs on: `mesh`'s axes,
    each of size 1."""
    return abstract_mesh((1,) * len(mesh.axis_names), mesh.axis_names)


def build_cell(arch_name: str, shape_name: str, mesh,
               cfg_override: Optional[ArchConfig] = None,
               batch: Optional[int] = None,
               seq: Optional[int] = None) -> Dict[str, Any]:
    """dict(skip, fn, args, in_specs, out_specs, outs, meta, cfg): fn(*args)
    runs the cell's step; args are meta tensors (decode's position a
    Python int); in_specs and out_specs mirror args and the outputs;
    outs are the outputs' meta tensors where out_specs lays them out
    (None for prefill, whose output layout the reference leaves to its
    compiler). `cfg_override` substitutes a modified ArchConfig (depth
    cuts); `batch` and `seq` override the shape's (a cut cell)."""
    cfg = cfg_override if cfg_override is not None else get_config(arch_name)
    sh = SHAPES[shape_name]
    b = sh["batch"] if batch is None else batch
    s = sh["seq"] if seq is None else seq
    kind = sh["kind"]
    ok, why = cell_applicable(cfg, shape_name)
    if not ok:
        return {"skip": True, "reason": why, "cfg": cfg}

    one = step_mesh(mesh)
    params_abs = M.abstract_params(cfg)
    meta = {"arch": cfg.name, "shape": shape_name, "kind": kind,
            "batch": b, "seq": s}

    if kind == "train":
        pspecs = M.param_specs(cfg, mesh)
        batch_abs = _batch_abstract(cfg, b, s, with_labels=True)
        opt_abs = abstract_adamw_state(params_abs)
        ospecs = adamw_state_specs(pspecs, mesh)
        metric_names = ["ce", "loss", "grad_norm"] + (
            ["aux"] if cfg.n_experts else []) + (
            ["mtp_ce"] if cfg.mtp else [])
        return dict(skip=False, fn=M.make_train_step(cfg, one),
                    args=(params_abs, opt_abs, batch_abs),
                    in_specs=(pspecs, ospecs,
                              _batch_specs(cfg, batch_abs, mesh)),
                    out_specs=(pspecs, ospecs,
                               {k: REPLICATED for k in sorted(metric_names)}),
                    outs=(params_abs, opt_abs,
                          {k: _meta((), torch.float32)
                           for k in sorted(metric_names)}),
                    meta=meta, cfg=cfg)

    if kind == "prefill":
        pspecs = M.param_specs(cfg, mesh)
        batch_abs = _batch_abstract(cfg, b, s, with_labels=False)
        return dict(skip=False, fn=M.make_prefill_step(cfg, one),
                    args=(params_abs, batch_abs),
                    in_specs=(pspecs, _batch_specs(cfg, batch_abs, mesh)),
                    out_specs=None, outs=None, meta=meta, cfg=cfg)

    # decode: serving rules (TP-only weights, the cache's seq over model)
    rules = serving_rules()
    pspecs = M.param_specs(cfg, mesh, rules)
    cache_abs = M.abstract_cache(cfg, b, s)
    cspecs = M.cache_specs(cfg, mesh, b, s, rules)
    dp = _dp_axes(mesh)
    tok_abs = _meta((b,), torch.int32)
    tok_spec = (normalize((dp,)) if dp and b % _axes_prod(mesh, dp) == 0
                else REPLICATED)
    return dict(skip=False, fn=M.make_serve_step(cfg),
                args=(params_abs, cache_abs, tok_abs, s - 1),
                in_specs=(pspecs, cspecs, tok_spec, REPLICATED),
                out_specs=(tok_spec, cspecs), outs=(tok_abs, cache_abs),
                meta=meta, cfg=cfg)


__all__ = ["SHAPES", "build_cell", "cell_applicable", "step_mesh"]
