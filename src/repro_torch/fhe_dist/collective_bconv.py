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
limbs, of any size and in rank order (none on some ranks), and with
whichever output limbs the rank wants; a block of unequal size is padded
for the collective and the padding dropped. `distributed_bconv` slices
the blocks from the whole arrays (`fhe_dist.layout`); `sharded_bconv`
takes a source that is already sharded, as the limb-sharded keyswitch's
digits and special limbs are (`fhe_dist.limb_ops`). Residues are int64
below 2^32 and every product goes through `core.modarith.mulmod`, so the
result is bit-equal to `core.rns.bconv` at the 32-bit special prime too.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import modarith as ma
from repro_torch.fhe_dist.layout import (AXIS, block_sizes, gather_blocks,
                                         local_block)
from repro_torch.launch.mesh import Mesh


def _local_reduce(v_chunk, w_chunk, dst_q):
    """Accumulate w^T v for one source chunk: v (..., s, N), w (s, D_l) ->
    (..., D_l, N) reduced mod dst_q (D_l, 1)."""
    acc = None
    for j in range(v_chunk.shape[-2]):
        term = ma.mulmod(v_chunk[..., j:j + 1, :], w_chunk[j][:, None],
                         dst_q)
        acc = term if acc is None else ma.addmod(acc, term, dst_q)
    return acc


def bconv_allgather_body(v_local, qhat_inv_local, src_q_local, w_local,
                         dst_q_local, *, mesh: Mesh, axis: str,
                         src_sizes: Sequence[int]):
    """v_local (..., S_l, N): this rank's source limbs, rank i of `axis`
    holding src_sizes[i] of the S in rank order (none on some ranks is
    allowed). w_local (S, D_l): the full source column of the weight
    matrix for the rank's D_l output limbs. Returns (..., D_l, N)."""
    vs = ma.mulmod(v_local, qhat_inv_local[:, None], src_q_local[:, None])
    v_all = gather_blocks(vs, src_sizes, mesh, axis)          # (..., S, N)
    return _local_reduce(v_all, w_local, dst_q_local[:, None])


def bconv_ring_body(v_local, qhat_inv_local, src_q_local, w_local,
                    dst_q_local, *, mesh: Mesh, axis: str,
                    src_sizes: Sequence[int]):
    """Ring schedule: rotate the local chunk (padded to the largest
    block) around the `model` ring, accumulating into the local outputs
    at each hop (chain network)."""
    n_dev = mesh.axis_size(axis)
    my = mesh.axis_index(axis)
    vs = ma.mulmod(v_local, qhat_inv_local[:, None], src_q_local[:, None])
    offsets = [sum(src_sizes[:i]) for i in range(n_dev)]
    width = max(src_sizes)
    dst_q = dst_q_local[:, None]
    acc = vs.new_zeros(vs.shape[:-2] + (w_local.shape[1], vs.shape[-1]))
    chunk = torch.cat([vs, vs.new_zeros(vs.shape[:-2] + (
        width - vs.shape[-2], vs.shape[-1]))], dim=-2)
    for hop in range(n_dev):
        # chunk holds the limbs of rank (my - hop) mod n_dev: its weight
        # rows are that rank's block of the source column
        src_dev = (my - hop) % n_dev
        s = src_sizes[src_dev]
        if s:
            w_rows = w_local[offsets[src_dev]:offsets[src_dev] + s]
            acc = ma.addmod(acc, _local_reduce(chunk[..., :s, :], w_rows,
                                               dst_q), dst_q)
        if hop != n_dev - 1:
            chunk = mesh.ring_shift(chunk, axis)
    return acc


VARIANTS = {"ring": bconv_ring_body, "allgather": bconv_allgather_body}


def distributed_bconv(v, qhat_inv, src_q, w, dst_q, mesh: Mesh,
                      variant: str = "ring", gather: bool = False):
    """v: (S, N) coefficient-domain source (already reduced mod the source
    primes), w: (S, D), whole on every rank. Returns this rank's (D_l, N)
    block of the (D, N) result, or the whole of it with ``gather``. S and
    D split over the `model` axis by `layout.block`'s rule, evenly or
    not."""
    m = (AXIS,)
    k = mesh.axis_size(AXIS)
    out = sharded_bconv(local_block(v, (AXIS, None), mesh),
                        local_block(qhat_inv, m, mesh),
                        local_block(src_q, m, mesh),
                        local_block(w, (None, AXIS), mesh),
                        local_block(dst_q, m, mesh),
                        block_sizes(v.shape[0], k), mesh, variant)
    return (gather_blocks(out, block_sizes(w.shape[1], k), mesh, AXIS)
            if gather else out)


def sharded_bconv(v_local, qhat_inv_local, src_q_local, w_local,
                  dst_q_local, src_sizes: Sequence[int], mesh: Mesh,
                  variant: str):
    """BConv of a source that is already sharded: rank i of `model` holds
    src_sizes[i] source limbs in rank order (`v_local`, with their
    qhat_inv and primes), and w_local (S, D_l) / dst_q_local (D_l,) name
    whichever destination limbs the rank wants. Returns (..., D_l, N)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: "
                         f"{', '.join(sorted(VARIANTS))}")
    return VARIANTS[variant](v_local, qhat_inv_local, src_q_local, w_local,
                             dst_q_local, mesh=mesh, axis=AXIS,
                             src_sizes=src_sizes)


def bconv_tables_device(ctx, src_idx, dst_idx):
    """(qhat_inv, src_q, w, dst_q) tensors for distributed_bconv, on the
    context's device."""
    t = ctx.bconv_tables(src_idx, dst_idx)
    return t.qhat_inv, t.src_q, t.w, t.dst_q


__all__ = ["bconv_allgather_body", "bconv_ring_body", "distributed_bconv",
           "sharded_bconv", "bconv_tables_device", "VARIANTS"]
