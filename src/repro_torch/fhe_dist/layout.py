"""Limb-sharded data layout for distributed FHE (paper §IV-A on a mesh).

The bank <-> limb mapping transfers directly: the RNS limbs of each
polynomial are split along the `model` axis (banks) in contiguous
blocks, so rank r of n holds limbs [r·L/n, (r+1)·L/n); the batch of
independent ciphertexts goes along `data` (separate pipelines), and
pods replicate keys (stack-level distribution in §V-A's 2-stack
system).

Uneven splits. When n items do not split evenly over k ranks, every
block has c = ceil(n / k) items but the last ones: rank i holds
[min(i·c, n), min((i+1)·c, n)). Blocks stay contiguous and in rank
order; the ranks past the end hold fewer items or none (12 limbs on 8
ranks: 2 each on ranks 0-5, none on 6-7; 7 limbs on 8 ranks: 1 each on
ranks 0-6). This is GSPMD's rule for a dimension that does not divide.
When n divides, every block is n / k items, as before. A collective
over blocks of unequal size (`gather_blocks`) pads each block to the
largest and drops the padding after.

Every rank holds the whole array and takes its block with
`local_block(x, spec, mesh)`; a spec names, per dimension, the mesh
axis it is split along (None: not split):

    ciphertext  (2, L, N)        -> (None, 'model', None)
    ct batch    (B, 2, L, N)     -> ('data', None, 'model', None)
    evk         (dnum, 2, T, N)  -> (None, None, 'model', None)
    NTT tables  (L, N)           -> ('model', None)

The limb-sharded keyswitch (`fhe_dist.limb_ops`) splits its basis Q ∪ P
as two such arrays: the Q limbs by the ciphertext's rule, the special
limbs P on their own, so a rank's Q limbs never move.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.launch.mesh import Mesh

Spec = Tuple[Optional[str], ...]

AXIS = "model"      # the mesh axis the limbs split along


def limb_specs(mesh: Mesh) -> Dict[str, Spec]:
    m = "model" if "model" in mesh.axis_names else mesh.axis_names[-1]
    d = "data" if "data" in mesh.axis_names else mesh.axis_names[0]
    return {
        "ct": (None, m, None),
        "ct_batch": (d, None, m, None),
        "poly": (m, None),
        "evk": (None, None, m, None),
        "tables": (m, None),
        "replicated": (),
    }


def _width(n: int, k: int) -> int:
    """c = ceil(n / k), the items of every block but the last ones."""
    return -(-n // k)


def block_range(n: int, k: int, i: int) -> range:
    """Items rank i of k holds of n."""
    c = _width(n, k)
    return range(min(i * c, n), min((i + 1) * c, n))


def block_sizes(n: int, k: int) -> List[int]:
    """Items each of k ranks holds of n under the rule above."""
    return [len(block_range(n, k, i)) for i in range(k)]


def owner(n: int, k: int, item: int) -> int:
    """The rank of k that holds `item` of n."""
    return item // _width(n, k)


def block(n: int, mesh: Mesh, axis: str) -> slice:
    """This rank's contiguous block of `n` items split along `axis`."""
    r = block_range(n, mesh.axis_size(axis), mesh.axis_index(axis))
    return slice(r.start, r.stop)


def local_block(x: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the whole array `x` under `spec`."""
    idx = tuple(slice(None) if axis is None else block(x.shape[d], mesh, axis)
                for d, axis in enumerate(spec))
    return x[idx]


def gather_blocks(t: torch.Tensor, sizes: Sequence[int], mesh: Mesh,
                  axis: str) -> torch.Tensor:
    """The whole limbs (dim -2) from each rank's block `t`, where rank i
    of `axis` holds sizes[i] limbs in rank order: each block is padded to
    the largest, all-gathered, and the padding dropped."""
    width = max(sizes)
    t = t.movedim(-2, 0)
    pad = t.new_zeros((width - t.shape[0],) + t.shape[1:])
    parts = mesh.all_gather(torch.cat([t, pad]), axis).split(width)
    return torch.cat([p[:s] for p, s in zip(parts, sizes)]).movedim(0, -2)


def gather(t: torch.Tensor, n: int, mesh: Mesh) -> torch.Tensor:
    """The whole limbs (dim -2) of `n` from each rank's `block(n)` `t`
    along `model` (n is passed: a rank cannot tell it from its own
    block)."""
    return gather_blocks(t, block_sizes(n, mesh.axis_size(AXIS)), mesh, AXIS)


def regroup(t: torch.Tensor, held: Sequence[int], n: int, mesh: Mesh
            ) -> torch.Tensor:
    """This rank's `block(n)` along `model` of `n` limbs (dim -2) of
    which rank i holds held[i] contiguously in rank order (`t` is this
    rank's). No collective when the holdings already are the blocks, as
    when the last limbs are dropped and the blocks keep their size."""
    if list(held) == block_sizes(n, mesh.axis_size(AXIS)):
        return t
    b = block(n, mesh, AXIS)
    return gather_blocks(t, held, mesh, AXIS)[..., b.start:b.stop, :]


def shardable_limbs(n_limbs: int, mesh: Mesh) -> bool:
    """Whether `n_limbs` split evenly over the `model` axis."""
    return n_limbs % mesh.shape.get("model", 1) == 0


__all__ = ["Spec", "AXIS", "limb_specs", "block_sizes", "block_range",
           "owner", "block", "local_block", "gather_blocks", "gather",
           "regroup", "shardable_limbs"]
