"""AdamW on trees of tensors: the port of ``repro.train.optim``.

The reference's formula and order: b2 = 0.95, bias correction by the
step count (in float32), weight decay only on leaves of more than one
axis, and the update lr * (m_hat / (sqrt(v_hat) + eps) + wd * p) formed
in float32 and cast back to the leaf's dtype. Not torch.optim.AdamW,
whose decay and step differ.

Parameters, m and v are updated in place (the reference's jitted step
returns new buffers; holding both copies would double the state), a
slice of at most CHUNK elements at a time (a meta tensor in one), so a
leaf's float32 temporaries stay small; the arithmetic is elementwise, so
the slicing changes no value. `abstract_adamw_state` and
`adamw_state_specs` give the state's meta tensors and specs for the dry
run: m and v take their parameters' specs (FSDP'd parameters give
ZeRO-sharded states).

In the partitioned step the parameters are DTensors: m and v are
DTensors laid out as their parameters (the reference's optimizer state
takes its parameters' shardings), the step count a plain tensor on each
rank, the clip's norm a sum over every rank's blocks (a DTensor
reduction, so the norm stays global), and the update runs on each rank's
own blocks of p, g, m and v.
"""
from __future__ import annotations

import torch

from repro_torch.models.model import tree_items, tree_map
from repro_torch.sharding import dtensor as sd

F32 = torch.float32
CHUNK = 1 << 26     # elements of a leaf updated at once (256 MB of float32)


def _zeros(p):
    if sd.is_dtensor(p):     # laid out as its parameter
        return torch.zeros_like(p, dtype=F32)
    return torch.zeros(p.shape, dtype=F32, device=p.device)


def adamw_init(params):
    device = next(tree_items(params))[1].device
    return {
        "m": tree_map(_zeros, params),
        "v": tree_map(_zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def abstract_adamw_state(params_abstract):
    """The state adamw_init makes, as meta tensors (meta DTensors laid out
    as their parameters where these are DTensors)."""
    def meta(p):
        if sd.is_dtensor(p):
            return torch.empty_like(p, dtype=F32)
        return torch.empty(p.shape, dtype=F32, device="meta")
    return {"m": tree_map(meta, params_abstract),
            "v": tree_map(meta, params_abstract),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def adamw_state_specs(param_specs, mesh):
    """m and v laid out as their parameters; the step replicated."""
    return {"m": param_specs, "v": param_specs, "step": ()}


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / global norm), global norm)."""
    leaves = [g for _, g in tree_items(grads)]
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(F32))) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp_min(gn, 1e-9), max=1.0)
    return tree_map(lambda g: (g.to(F32) * scale).to(g.dtype), grads), gn


def _local(x):
    return x.to_local() if sd.is_dtensor(x) else x


@torch.no_grad()
def adamw_update(params, grads, state, lr: float = 3e-4, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, wd: float = 0.1):
    """One AdamW step: params, state["m"] and state["v"] are written in
    place; returns (params, the state with the new step count)."""
    step = state["step"] + 1
    t = _local(step).to(F32)
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t

    def upd(p, g, m, v, decay: bool):
        gf = g.to(F32)
        m_new = b1 * m + (1 - b1) * gf
        v_new = b2 * v + (1 - b2) * gf * gf
        update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
        pf = p.to(F32)
        # no weight decay on 1-D (norm/bias) params
        pf_new = pf - lr * (update + wd * (pf if decay
                                           else torch.zeros_like(pf)))
        m.copy_(m_new)
        v.copy_(v_new)
        p.copy_(pf_new.to(p.dtype))

    rows = zip(tree_items(params), tree_items(grads),
               tree_items(state["m"]), tree_items(state["v"]))
    for (path, p), (gpath, g), (_, m), (_, v) in rows:
        if gpath != path:
            raise ValueError(f"gradient {gpath} against parameter {path}")
        if sd.is_dtensor(p):
            # elementwise: each rank updates its own blocks
            if not all(tuple(x.placements) == tuple(p.placements)
                       for x in (g, m, v)):
                raise ValueError(f"{'/'.join(path)}: gradient or state "
                                 f"laid out unlike the parameter")
            p, g, m, v = (x.to_local() for x in (p, g, m, v))
        if not all(x.is_contiguous() for x in (p, m, v)):
            raise ValueError(f"{'/'.join(path)}: AdamW updates contiguous "
                             f"leaves in place")
        flat = [x.view(-1) for x in (p, g.contiguous(), m, v)]
        # meta tensors (the dry run's count) hold no temporaries to bound
        chunk = max(p.numel(), 1) if p.is_meta else CHUNK
        for i in range(0, p.numel(), chunk):
            upd(*(x[i:i + chunk] for x in flat), decay=p.ndim > 1)
    return params, {"m": state["m"], "v": state["v"], "step": step}
