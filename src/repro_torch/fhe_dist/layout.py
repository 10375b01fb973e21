"""Limb-sharded data layout for distributed FHE (paper §IV-A on a mesh).

The bank <-> limb mapping transfers directly: the RNS limbs of each
polynomial are split along the `model` axis (banks) in contiguous
blocks, so rank r of n holds limbs [r·L/n, (r+1)·L/n); the batch of
independent ciphertexts goes along `data` (separate pipelines), and
pods replicate keys (stack-level distribution in §V-A's 2-stack
system).

Every rank holds the whole array and takes its block with
`local_block(x, spec, mesh)`; a spec names, per dimension, the mesh
axis it is split along (None: not split):

    ciphertext  (2, L, N)        -> (None, 'model', None)
    ct batch    (B, 2, L, N)     -> ('data', None, 'model', None)
    evk         (dnum, 2, T, N)  -> (None, None, 'model', None)
    NTT tables  (L, N)           -> ('model', None)
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.launch.mesh import Mesh

Spec = Tuple[Optional[str], ...]


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


def block(n: int, mesh: Mesh, axis: str) -> slice:
    """This rank's contiguous block of `n` items split along `axis`."""
    k = mesh.axis_size(axis)
    if n % k:
        raise ValueError(f"{n} items do not split evenly over the {k} "
                         f"ranks of mesh axis {axis!r}")
    size = n // k
    i = mesh.axis_index(axis)
    return slice(i * size, (i + 1) * size)


def local_block(x: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the whole array `x` under `spec`."""
    idx = tuple(slice(None) if axis is None else block(x.shape[d], mesh, axis)
                for d, axis in enumerate(spec))
    return x[idx]


def shardable_limbs(n_limbs: int, mesh: Mesh) -> bool:
    return n_limbs % mesh.shape.get("model", 1) == 0


__all__ = ["Spec", "limb_specs", "block", "local_block", "shardable_limbs"]
