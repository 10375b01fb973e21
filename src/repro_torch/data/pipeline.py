"""Data pipeline: deterministic synthetic LM token streams (replay-exact
for failure recovery — batch contents are a pure function of the step
index) plus the host -> device copy, or the layout of a batch over a
mesh's data-parallel axes. The port of ``repro.data.pipeline``:
the same numpy draws in the same order, so both packages see the same
batches.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.models.config import ArchConfig


class SyntheticLMDataset:
    """Markov-ish synthetic tokens with per-step determinism."""

    def __init__(self, cfg: ArchConfig, batch: int, seq: int,
                 seed: int = 1234):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed + step)
        cfg = self.cfg
        # zipfian-ish marginals so losses move like real text
        z = rng.zipf(1.3, size=(self.batch, self.seq + 1))
        tokens_full = (z % cfg.vocab).astype(np.int32)
        out = {"tokens": tokens_full[:, :-1],
               "labels": tokens_full[:, 1:]}
        if cfg.xattn_period:
            out["images"] = rng.normal(
                0, 1, (self.batch, cfg.n_img_tokens, cfg.d_model)
            ).astype(np.float32)
        if cfg.enc_dec:
            out["frames"] = rng.normal(
                0, 1, (self.batch, self.seq, cfg.d_model)).astype(np.float32)
        return out


def shard_batch(batch: Dict[str, np.ndarray], device_or_mesh,
                dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Host batch -> tensors: integer arrays keep their dtype, float
    arrays become `dtype`. Given a device, plain tensors on it (one
    device: the reference's data-parallel sharding has one shard); given
    a launch.mesh.Mesh, DTensors on its device laid out over its
    data-parallel axes, the rest replicated (the reference's
    NamedSharding(mesh, P(dp, None, ...))): each rank keeps its own rows
    of the same host batch."""
    mesh = device_or_mesh if hasattr(device_or_mesh, "axis_names") else None
    device = mesh.device if mesh is not None else device_or_mesh

    def put(x):
        t = torch.from_numpy(np.ascontiguousarray(x))
        if x.dtype.kind not in "iu":
            t = t.to(dtype)
        t = t.to(device)
        if mesh is None:
            return t
        from repro_torch.sharding.dtensor import distribute
        dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
        return distribute(t, mesh, (dp,) + (None,) * (t.dim() - 1))

    return {k: put(v) for k, v in batch.items()}
