"""Shared benchmark helpers of the port (`benchmarks/common.py` imports
jax, so the port keeps its own)."""
from __future__ import annotations

import json
import os
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


# the "device" of a record whose driver placed no tensor: it ran only the
# analytic or discrete-event models, on the host
HOST = "host"


def row(name: str, us: float, derived: str = "") -> None:
    print(f"{name},{us:.1f},{derived}")


def emit(records: list, name: str, us: float, derived: str = "",
         **extra) -> None:
    """Print one CSV row and keep it as a record."""
    row(name, us, derived)
    records.append({"name": name, "us_per_call": us, "derived": derived,
                    **extra})


def write_records(fname: str, records, device, **common) -> str:
    """Rewrite RESULTS/fname with one JSON line a record, each carrying
    `device` (a torch device, or HOST) and the `common` fields."""
    os.makedirs(RESULTS, exist_ok=True)
    path = os.path.join(RESULTS, fname)
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps({**r, **common, "device": str(device)})
                    + "\n")
    return path


def mem_profile(name: str):
    """Flat MemoryModel of a named hardware preset: the same registry
    (repro_torch.pim.arch) `serve_fhe --mem-profile` and the pim backend
    use."""
    from repro_torch.pim.arch import memory_model
    return memory_model(name)


def pim_arch(name: str):
    """Hierarchical arch of a named hardware preset (repro_torch.pim.arch)."""
    from repro_torch.pim.arch import get_arch
    return get_arch(name)


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
