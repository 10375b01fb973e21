"""Data pipeline: deterministic synthetic LM token streams (replay-exact
for failure recovery — batch contents are a pure function of the step
index) plus the host -> device copy. The port of ``repro.data.pipeline``:
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


def shard_batch(batch: Dict[str, np.ndarray], device,
                dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Host batch -> tensors on `device`: integer arrays keep their dtype,
    float arrays become `dtype` (one device: the reference's data-parallel
    sharding has one shard)."""
    def put(x):
        t = torch.from_numpy(np.ascontiguousarray(x))
        if x.dtype.kind not in "iu":
            t = t.to(dtype)
        return t.to(device)

    return {k: put(v) for k, v in batch.items()}
