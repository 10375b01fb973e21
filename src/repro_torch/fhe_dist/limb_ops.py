"""Limb-sharded CKKS algebra over a `Mesh`: HMul, HSquare, rotation,
rescale and the keyswitch under them (paper §IV-A: one bank per limb,
BConv the only step that crosses banks).

The reference gets this from XLA's GSPMD, which partitions its
single-device `core/ops` when the ciphertext is sharded by limb. PyTorch
has no GSPMD, so `LimbShard` is a `core.ops.Basis` that holds one rank's
limbs, and `core.ops` runs on it step by step
(`ops.hmul(ctx, a, b, key, basis=sh)`, and so `hsquare`, `rotate`,
`rescale`, `key_switch`, `mod_up`, `_mod_down`, `mod_switch_to_level`):

* local: the tensor product, the (i)NTTs of the rank's limbs, the evk
  product and accumulate, ModDown's subtract and × P^-1, and the Galois
  permutation (it acts along N, inside each limb);
* ModUp, per digit: the digit's limbs sit on the ranks that hold them;
  `collective_bconv.sharded_bconv` (ring or all-gather) converts them
  into every rank's other limbs;
* ModDown: the BConv P -> Q over the same collectives, from the ranks
  that hold special limbs;
* rescale: the last limb's coefficient form is broadcast from the rank
  that holds it; where the blocks of the shorter basis are not the old
  ones less the dropped limb, the result is regrouped (`layout.regroup`).

Layout (`fhe_dist.layout`): a ciphertext at level l holds its l + 1 Q
limbs in `block(l + 1)` along `model` (a batch also along `data`,
`limb_specs["ct_batch"]`). The keyswitch's basis Q_l ∪ P is, on each
rank, its Q block followed by its `block(n_p)` of the special limbs,
and the key a rank holds (`shard_key`) is those limbs of the key. A
`Ciphertext` here holds this rank's block in `data`; its level and scale
are the whole ciphertext's. Residues are int64 below 2^32 and every
product goes through `core.modarith.mulmod`, so the gathered results are
bit-equal to `core.ops` on one device, with the 32-bit special prime
3221225473 too.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch

from repro_torch.core.ciphertext import Ciphertext, KeySwitchKey
from repro_torch.core.context import CkksContext
from repro_torch.core.ops import Basis
from repro_torch.fhe_dist import layout
from repro_torch.fhe_dist.collective_bconv import sharded_bconv
from repro_torch.fhe_dist.layout import AXIS, block_range
from repro_torch.launch.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class LimbShard(Basis):
    """One rank's limbs along the mesh's `model` axis, and the BConv
    schedule ("ring" or "allgather") its steps across ranks use. The
    context (host tables) is whole on every rank; a rank reads only its
    own limbs' rows."""
    mesh: Mesh
    variant: str = "ring"

    @property
    def ranks(self) -> int:
        return self.mesh.axis_size(AXIS)

    @property
    def index(self) -> int:
        return self.mesh.axis_index(AXIS)

    def _own(self, ctx: CkksContext, idx: Sequence[int], rank: int
             ) -> List[int]:
        q = [g for g in idx if g < ctx.n_q]
        p = [g for g in idx if g >= ctx.n_q]
        return ([q[i] for i in block_range(len(q), self.ranks, rank)]
                + [p[i] for i in block_range(len(p), self.ranks, rank)])

    def q_range(self, level: int) -> range:
        return block_range(level + 1, self.ranks, self.index)

    def own(self, ctx: CkksContext, idx: Sequence[int]) -> List[int]:
        return self._own(ctx, idx, self.index)

    def bconv(self, ctx: CkksContext, v: torch.Tensor, src: Sequence[int],
              dst: Sequence[int]) -> torch.Tensor:
        # rank i holds the limbs of src that its block of src ∪ dst holds
        basis = sorted({*src, *dst})
        held = [set(self._own(ctx, basis, i)) for i in range(self.ranks)]
        sizes = [sum(g in h for g in src) for h in held]
        t = ctx.bconv_tables(src, [g for g in dst if g in held[self.index]])
        off = sum(sizes[:self.index])
        mine = slice(off, off + sizes[self.index])
        return sharded_bconv(v, t.qhat_inv[mine], t.src_q[mine], t.w,
                             t.dst_q, sizes, self.mesh, self.variant)

    def last_limb(self, ctx: CkksContext, data: torch.Tensor, level: int
                  ) -> torch.Tensor:
        # coefficient form on the rank that holds it, then to every rank
        owner = layout.owner(level + 1, self.ranks, level)
        if self.index == owner:
            c = ctx.intt(data[..., -1:, :], [level])
        else:
            c = data.new_empty(data.shape[:-2] + (1, ctx.n))
        return self.mesh.broadcast(c, AXIS, owner)

    def regroup(self, t: torch.Tensor, n_old: int, n_new: int
                ) -> torch.Tensor:
        held = [max(0, min(r.stop, n_new) - r.start)
                for r in (block_range(n_old, self.ranks, i)
                          for i in range(self.ranks))]
        return layout.regroup(t, held, n_new, self.mesh)

    def key(self, ksk: KeySwitchKey, tix: torch.Tensor) -> torch.Tensor:
        if ksk.data.shape[-2] != len(tix):
            raise ValueError(f"key of {ksk.data.shape[-2]} limbs against "
                             f"this rank's {len(tix)}: shard it with "
                             f"shard_key at the ciphertext's level")
        return ksk.data


def shard_ciphertext(sh: LimbShard, ct: Ciphertext) -> Ciphertext:
    """This rank's block of a whole ciphertext (2, L, N), or of a batch
    (B, 2, L, N), which also splits along `data`."""
    specs = layout.limb_specs(sh.mesh)
    spec = specs["ct_batch"] if ct.data.dim() == 4 else specs["ct"]
    return Ciphertext(layout.local_block(ct.data, spec, sh.mesh), ct.level,
                      ct.scale)


def gather_ciphertext(sh: LimbShard, ct: Ciphertext) -> Ciphertext:
    """The whole limbs of a sharded ciphertext, on every rank of its
    `model` line (a batch stays split along `data`)."""
    return Ciphertext(layout.gather(ct.data, ct.level + 1, sh.mesh),
                      ct.level, ct.scale)


def shard_key(sh: LimbShard, ctx: CkksContext, ksk: KeySwitchKey,
              level: int) -> KeySwitchKey:
    """This rank's limbs of a whole key (dnum, 2, n_q + n_p, N) for a
    keyswitch at `level`."""
    basis = sh.own(ctx, ctx.q_idx(level) + ctx.p_idx())
    return KeySwitchKey(ksk.data[:, :, ctx.index(basis)])


__all__ = ["LimbShard", "shard_ciphertext", "gather_ciphertext",
           "shard_key"]
