"""Shared benchmark helpers of the port (`benchmarks/common.py` imports
jax, so the port keeps its own)."""
from __future__ import annotations

import time

import numpy as np
import torch


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
