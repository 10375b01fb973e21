"""Distributed BConv: the paper's inter-bank all-to-all (§III-C, §IV-D)
as collectives along the mesh's `model` axis, in two schedules.

* `bconv_allgather` — the "channel IO" baseline (paper Base1): every
  rank gathers all source limbs (one all-gather over `model`), then
  reduces its own output limbs locally. One bulk collective on the
  shared-bus analogue.
* `bconv_ring` — the "partial chain network" (the paper's contribution):
  source limbs circulate around the `model` ring, one neighbour send a
  hop; each hop's chunk is multiply-accumulated into the local output
  limbs. Same total bytes, but neighbour links only.

Each body runs on every rank with its own contiguous block of source
limbs and of output limbs (`fhe_dist.layout`); `distributed_bconv`
slices the blocks from the whole arrays. Residues are int64 below 2^32
and every product goes through `core.modarith.mulmod`, so the result is
bit-equal to `core.rns.bconv` at the 32-bit special prime too.
"""
from __future__ import annotations

import torch

from repro_torch.core import modarith as ma
from repro_torch.fhe_dist.layout import local_block
from repro_torch.launch.mesh import Mesh


def _local_reduce(v_chunk, w_chunk, dst_q):
    """Accumulate w^T v for one source chunk: v (s, N), w (s, D_l) ->
    (D_l, N) reduced mod dst_q (D_l, 1)."""
    acc = None
    for j in range(v_chunk.shape[0]):
        term = ma.mulmod(v_chunk[j][None, :], w_chunk[j][:, None], dst_q)
        acc = term if acc is None else ma.addmod(acc, term, dst_q)
    return acc


def bconv_allgather_body(v_local, qhat_inv_local, src_q_local, w_local,
                         dst_q_local, *, mesh: Mesh, axis: str):
    """v_local (S_l, N): this rank's source limbs. w_local (S, D_l): the
    full source column of the weight matrix for the rank's D_l output
    limbs. Returns (D_l, N)."""
    vs = ma.mulmod(v_local, qhat_inv_local[:, None], src_q_local[:, None])
    v_all = mesh.all_gather(vs, axis)                          # (S, N)
    return _local_reduce(v_all, w_local, dst_q_local[:, None])


def bconv_ring_body(v_local, qhat_inv_local, src_q_local, w_local,
                    dst_q_local, *, mesh: Mesh, axis: str):
    """Ring schedule: rotate the local chunk around the `model` ring,
    accumulating into the local outputs at each hop (chain network)."""
    n_dev = mesh.axis_size(axis)
    my = mesh.axis_index(axis)
    vs = ma.mulmod(v_local, qhat_inv_local[:, None], src_q_local[:, None])
    s_l = vs.shape[0]
    dst_q = dst_q_local[:, None]
    acc = torch.zeros((w_local.shape[1], vs.shape[1]), dtype=torch.int64,
                      device=vs.device)
    chunk = vs
    for hop in range(n_dev):
        # chunk holds the limbs of rank (my - hop) mod n_dev: its weight
        # rows are that rank's block of the source column
        src_dev = (my - hop) % n_dev
        w_rows = w_local[src_dev * s_l:(src_dev + 1) * s_l]
        acc = ma.addmod(acc, _local_reduce(chunk, w_rows, dst_q), dst_q)
        if hop != n_dev - 1:
            chunk = mesh.ring_shift(chunk, axis)
    return acc


VARIANTS = {"ring": bconv_ring_body, "allgather": bconv_allgather_body}


def distributed_bconv(v, qhat_inv, src_q, w, dst_q, mesh: Mesh,
                      variant: str = "ring", gather: bool = False):
    """v: (S, N) coefficient-domain source (already reduced mod the source
    primes), w: (S, D), whole on every rank. Returns this rank's (D_l, N)
    block of the (D, N) result, or the whole of it with ``gather``. S and
    D must split evenly over the `model` axis."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: "
                         f"{', '.join(sorted(VARIANTS))}")
    axis = "model"
    m = (axis,)
    out = VARIANTS[variant](
        local_block(v, (axis, None), mesh), local_block(qhat_inv, m, mesh),
        local_block(src_q, m, mesh), local_block(w, (None, axis), mesh),
        local_block(dst_q, m, mesh), mesh=mesh, axis=axis)
    return mesh.all_gather(out, axis) if gather else out


def bconv_tables_device(ctx, src_idx, dst_idx):
    """(qhat_inv, src_q, w, dst_q) tensors for distributed_bconv, on the
    context's device."""
    t = ctx.bconv_tables(src_idx, dst_idx)
    return t.qhat_inv, t.src_q, t.w, t.dst_q


__all__ = ["bconv_allgather_body", "bconv_ring_body", "distributed_bconv",
           "bconv_tables_device", "VARIANTS"]
