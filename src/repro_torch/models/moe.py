"""Token-choice top-k Mixture of Experts: the two dispatch schedules.

The PyTorch counterpart of ``repro.models.moe``: `router`,
`_dispatch_indices`, `expert_ffn`, `moe_psum`, `moe_all_to_all` and
`moe_reference` (a test oracle).

* `moe_psum` (any token count, decode included): every rank along the
  mesh's `model` axis holds the same tokens and its own block of the
  experts; it runs only its experts and the partial outputs are summed
  over `model` (`sharding.dtensor.psum`, an all-reduce on the mesh's
  group). Without a mesh, or at one rank, the rank holds every expert and
  there is nothing to sum.
* `moe_all_to_all` (training/prefill) puts each expert's slots in a
  per-expert buffer and moves them to the experts' owners with one
  all_to_all along the mesh's `model` axis (`Mesh.all_to_all`, which has
  a gradient: the reverse exchange); a second all_to_all brings the
  outputs back. At one rank both schedules compute the same values.

Dispatch is capacity based (capacity_factor, overflow dropped) and ranked
by a cumsum over the flattened (T*k) slots, as in the reference. The
reference's out-of-range scatter (mode="drop") and gather (mode="fill")
become a dump row: a dropped slot is scattered to one extra row past the
buffer and gathered from a zero row there, so no index wraps and no host
sync is needed; a dropped slot's gradient is 0, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.sharding.dtensor import psum

F32 = torch.float32


def top_k(probs, k: int):
    """jax.lax.top_k: the k largest along the last axis, in descending
    order, the lower index first among equal values (a stable sort)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def router(x, w_router, top_k_: int):
    """x (T, D) -> (weights (T,k), ids (T,k), aux_loss scalar, probs (T,E))."""
    logits = torch.einsum("td,de->te", x, w_router).to(F32)
    probs = torch.softmax(logits, dim=-1)
    weights, ids = top_k(probs, top_k_)
    weights = weights / torch.clamp_min(weights.sum(-1, keepdim=True), 1e-9)
    # load-balancing aux loss (Switch-style): E * sum_e f_e * P_e
    e = probs.shape[-1]
    density = torch.zeros((e,), dtype=F32, device=x.device).index_add_(
        0, ids.reshape(-1), torch.ones(ids.numel(), dtype=F32,
                                       device=x.device))
    density = density / ids.numel()
    p_mean = probs.mean(0)
    aux = e * torch.sum(density * p_mean)
    return weights.to(x.dtype), ids, aux, probs


def _dispatch_indices(ids, e_total: int, capacity: int):
    """Rank each (token, k-slot) within its expert. Returns flat positions
    (T*k,) and a keep mask (positions below `capacity`; overflow dropped)."""
    flat = ids.reshape(-1).long()                            # (T*k,)
    onehot = F.one_hot(flat, e_total)                        # (T*k, E)
    ranks = torch.cumsum(onehot, dim=0) - 1                  # rank within expert
    pos = torch.gather(ranks, 1, flat[:, None])[:, 0]
    keep = pos < capacity
    return pos, keep


def expert_ffn(buf, w_gate, w_up, w_down):
    """buf (E_l, C, D) x per-expert weights (E_l, D, F)."""
    g = torch.einsum("ecd,edf->ecf", buf, w_gate)
    u = torch.einsum("ecd,edf->ecf", buf, w_up)
    h = F.silu(g.to(F32)).to(buf.dtype) * u
    return torch.einsum("ecf,efd->ecd", h, w_down)


def capacity_of(t: int, cfg: ArchConfig) -> int:
    return max(int(t * cfg.top_k * cfg.capacity_factor / cfg.n_experts), 4)


def _dispatch(x, ids, e: int, capacity: int, top_k_: int):
    """The (E, capacity, D) buffer of each expert's slots and each (token,
    k-slot)'s row in it (the dump row E * capacity where dropped)."""
    d = x.shape[1]
    pos, keep = _dispatch_indices(ids, e, capacity)
    dump = e * capacity
    slot = torch.where(keep, ids.reshape(-1) * capacity + pos,
                       torch.full_like(pos, dump))
    xk = torch.repeat_interleave(x, top_k_, dim=0)           # (T*k, D)
    buf = x.new_zeros((dump + 1, d))
    buf[slot] = xk                                           # drop -> dump row
    return buf[:dump].reshape(e, capacity, d), slot


def _combine(out_buf, slot, weights, x):
    """Gather each slot's expert output (0 where dropped) and sum a
    token's top-k slots with the router's weights."""
    t, k = weights.shape
    d = x.shape[1]
    out_rows = torch.cat([out_buf.reshape(-1, d), x.new_zeros((1, d))])
    gathered = out_rows[slot]                                # fill -> 0
    combined = (gathered.reshape(t, k, d) * weights[..., None]).sum(dim=1)
    return combined.to(x.dtype)


def moe_psum(x, p, cfg: ArchConfig, mesh=None, axis: str = "model"):
    """x (T, D): the same tokens on every rank along `axis`; p's expert
    weights hold this rank's E_local = E / (ranks along `axis`) experts
    (every expert without a mesh). -> (combined (T, D), aux)."""
    t, _ = x.shape
    e = cfg.n_experts
    e_local = p["w_gate"].shape[0]
    n = 1 if mesh is None else mesh.axis_size(axis)
    if e_local * n != e:
        raise ValueError(f"{e_local} local experts on each of {n} ranks "
                         f"along {axis!r}; the config has {e}")
    weights, ids, aux, _ = router(x, p["w_router"], cfg.top_k)
    capacity = capacity_of(t, cfg)
    buf, slot = _dispatch(x, ids, e, capacity, cfg.top_k)
    if n == 1:
        out_buf = expert_ffn(buf, p["w_gate"], p["w_up"], p["w_down"])
        return _combine(out_buf, slot, weights, x), aux
    # run this rank's experts only; the others' rows stay 0 and come from
    # their owners through the sum
    lo = mesh.axis_index(axis) * e_local
    mine = expert_ffn(buf[lo:lo + e_local], p["w_gate"], p["w_up"],
                      p["w_down"])
    out_buf = torch.cat([buf.new_zeros((lo,) + buf.shape[1:]), mine,
                         buf.new_zeros((e - lo - e_local,) + buf.shape[1:])])
    return psum(_combine(out_buf, slot, weights, x), mesh.device_mesh,
                axis), aux


def moe_all_to_all(x, p, cfg: ArchConfig, mesh, axis: str = "model"):
    """x (T_local, D): this rank's tokens; p's expert weights hold this
    rank's E_local = E / (ranks along `axis`) experts. Each expert's slots
    go to its owner with one all_to_all and its outputs come back with
    another. -> (combined (T_local, D), aux)."""
    t, d = x.shape
    e = cfg.n_experts
    e_local = p["w_gate"].shape[0]
    n = mesh.axis_size(axis)
    if e_local * n != e:
        raise ValueError(f"{e_local} local experts on each of {n} ranks "
                         f"along {axis!r}; the config has {e}")
    weights, ids, aux, _ = router(x, p["w_router"], cfg.top_k)
    capacity = capacity_of(t, cfg)
    buf, slot = _dispatch(x, ids, e, capacity, cfg.top_k)
    # (E, C, D): rank j's experts to rank j; what rank i sends lands in
    # columns i*C..(i+1)*C of (E_local, n*C, D)
    buf = mesh.all_to_all(buf, axis).reshape(n, e_local, capacity, d)
    buf = buf.transpose(0, 1).reshape(e_local, n * capacity, d)
    out_buf = expert_ffn(buf, p["w_gate"], p["w_up"], p["w_down"])
    out_buf = out_buf.reshape(e_local, n, capacity, d).transpose(0, 1)
    out_buf = mesh.all_to_all(out_buf.reshape(e, capacity, d), axis)
    return _combine(out_buf, slot, weights, x), aux


def moe_reference(x, p_full, cfg: ArchConfig):
    """Single-device oracle: dense per-expert compute, no capacity drops."""
    t, d = x.shape
    weights, ids, aux, _ = router(x, p_full["w_router"], cfg.top_k)
    outs = expert_ffn(x.expand(cfg.n_experts, t, d),
                      p_full["w_gate"], p_full["w_up"], p_full["w_down"])
    # outs (E, T, D); combine top-k
    tok = torch.arange(t, device=x.device).repeat_interleave(cfg.top_k)
    sel = outs[ids.reshape(-1), tok]
    combined = (sel.reshape(t, cfg.top_k, d) * weights[..., None]).sum(1)
    return combined.to(x.dtype), aux
