"""Token-choice top-k Mixture of Experts, the decode schedule at one rank.

The PyTorch counterpart of ``repro.models.moe``'s `router`,
`_dispatch_indices`, `expert_ffn` and `moe_psum` (the schedule decode
uses), plus `moe_reference` as a test oracle. `moe_all_to_all` comes with
the training slice.

`moe_psum` is the reference's shard_map body at one rank, the (1, 1)
host mesh the reference's decode runs on: the rank holds every expert and
the psum is the identity.

Dispatch is capacity based (capacity_factor, overflow dropped) and ranked
by a cumsum over the flattened (T*k) slots, as in the reference. The
reference's out-of-range scatter (mode="drop") and gather (mode="fill")
become a dump row: a dropped slot is scattered to one extra row past the
buffer and gathered from a zero row there, so no index wraps and no host
sync is needed.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig

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


def moe_psum(x, p, cfg: ArchConfig):
    """x (T, D) -> (combined (T, D), aux), every expert on this rank."""
    t, d = x.shape
    e = cfg.n_experts
    weights, ids, aux, _ = router(x, p["w_router"], cfg.top_k)
    capacity = capacity_of(t, cfg)
    pos, keep = _dispatch_indices(ids, e, capacity)
    dump = e * capacity
    slot = torch.where(keep, ids.reshape(-1) * capacity + pos,
                       torch.full_like(pos, dump))
    xk = torch.repeat_interleave(x, cfg.top_k, dim=0)        # (T*k, D)
    buf = x.new_zeros((dump + 1, d))
    buf[slot] = xk                                           # drop -> dump row
    out_buf = expert_ffn(buf[:dump].reshape(e, capacity, d),
                         p["w_gate"], p["w_up"], p["w_down"])
    out_rows = torch.cat([out_buf.reshape(dump, d), x.new_zeros((1, d))])
    gathered = out_rows[slot]                                # fill -> 0
    combined = (gathered.reshape(t, cfg.top_k, d)
                * weights[..., None]).sum(dim=1)
    return combined.to(x.dtype), aux


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
