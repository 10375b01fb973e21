"""Shared benchmark helpers of the port (`benchmarks/common.py` imports
jax, so the port keeps its own)."""
from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

# where the port's benchmarks write their records (not committed)
RESULTS = Path(__file__).resolve().parents[3] / "build" / "repro_torch" / \
    "results"


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timeit(fn, *args, device: torch.device, warmup: int = 1,
           iters: int = 5) -> float:
    """Median wall seconds of fn(*args), the device synchronised before
    and after each call, so a time covers the device's work and not only
    its enqueue."""
    for _ in range(warmup):
        fn(*args)
    ts = []
    for _ in range(iters):
        sync(device)
        t0 = time.perf_counter()
        fn(*args)
        sync(device)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def row(name: str, us: float, derived: str = "") -> None:
    print(f"{name},{us:.1f},{derived}")


def synced(fn, *args, device: torch.device):
    """fn(*args) and its wall seconds, the device synchronised before and
    after, so the time covers the device's work and not only its enqueue."""
    sync(device)
    t0 = time.perf_counter()
    out = fn(*args)
    sync(device)
    return out, time.perf_counter() - t0


class CkksStack:
    """Context, encoder, seeded encryptor and secret key on one device,
    with encrypt and decrypt of slot vectors."""

    def __init__(self, params, device, seed: int):
        from repro_torch.core.context import CkksContext
        from repro_torch.core.encoder import CkksEncoder
        from repro_torch.core.encryptor import CkksEncryptor
        self.params = params
        self.ctx = CkksContext(params, device)
        self.enc = CkksEncoder(self.ctx)
        self.encr = CkksEncryptor(self.ctx, seed=seed)
        self.sk = self.encr.keygen()

    def encrypt(self, v, scale: float, level: int):
        from repro_torch.core.ciphertext import Plaintext
        return self.encr.encrypt_sk(
            Plaintext(self.enc.encode(v, scale, level), level, scale),
            self.sk)

    def decrypt(self, ct) -> np.ndarray:
        return self.enc.decode(self.encr.decrypt(ct, self.sk).data,
                               ct.scale, ct.level)
