"""Shared helpers of the kernel layer: dispatch and launch accounting,
device routing, and the plain-torch 32-bit Montgomery arithmetic that
mirrors ``csrc/common.cuh``.

Values are u32 residues (odd moduli < 2^32) carried in int64 tensors on
the plain path and in int32 tensors between kernels: the int32 holds the
u32 bit pattern (``.to(torch.int32)`` wraps, `u32` reads it back).
Montgomery radix R = 2^32.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.core.modarith import addmod as addmod32  # noqa: F401
from repro_torch.core.modarith import submod as submod32  # noqa: F401

# ---------------------------------------------------------------------------
# dispatch accounting (the reference's currency: launches per keyswitch)
# ---------------------------------------------------------------------------
# Every kernel launch site records itself here at the wrapper layer, on
# every device: FusedKeySwitch.apply records its 4 launches, ops.modmul
# its one. tests/golden/dispatch_counts.json pins the counts.

_dispatch_count = 0


def record_dispatch(n: int = 1) -> None:
    global _dispatch_count
    _dispatch_count += n


def dispatch_count() -> int:
    return _dispatch_count


def reset_dispatch_count() -> None:
    global _dispatch_count
    _dispatch_count = 0


# ---------------------------------------------------------------------------
# per-kernel launch counters (CUDA launches only)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KernelInfo:
    """One hand-written kernel: where it lives, what TPU kernel it
    replaces, and how many times its wrapper launched it on a card."""
    name: str
    source: str          # path in the repository
    replaces: str        # file:line of the Pallas kernel body
    launches: int = 0


KERNELS: Dict[str, KernelInfo] = {}


def register_kernel(name: str, source: str, replaces: str) -> KernelInfo:
    info = KernelInfo(name, source, replaces)
    KERNELS[name] = info
    return info


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def use_kernel(*tensors: torch.Tensor) -> bool:
    """Route of one wrapper call: False for CPU tensors (the plain
    version), True for CUDA tensors on one device (the kernel). Anything
    else is refused before any launch."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel operands on several devices: {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"no kernel or plain version for device {dev}: "
                     f"pass CPU tensors (plain version) or CUDA tensors")


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape) -> None:
    """Validate one kernel operand before its pointer is taken."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


# ---------------------------------------------------------------------------
# plain Montgomery arithmetic (int64 tensors, no intermediate > 2^63)
# ---------------------------------------------------------------------------

MASK32 = 0xFFFFFFFF


def mul_wide(a, b):
    """(hi, lo) 32-bit words of a*b for 0 <= a, b < 2^32, on int64
    without overflow: b is split in 16-bit halves, every partial product
    stays below 2^48."""
    x = a * (b & 0xFFFF)
    y = a * (b >> 16)                     # a*b = x + y * 2^16
    lo_sum = (x & MASK32) + ((y & 0xFFFF) << 16)
    return (x >> 32) + (y >> 16) + (lo_sum >> 32), lo_sum & MASK32


def mont_mul32(a, b, q, qinv_neg):
    """a*b*2^-32 mod q for a, b < q < 2^32 odd; qinv_neg = -q^{-1} mod
    2^32. The same REDC as ``csrc/common.cuh::mont_mul``: the low words
    of t and m*q sum to 0 or exactly 2^32 (carry iff t_lo != 0). The
    result in [0, q) is unique."""
    hi, lo = mul_wide(a, b)
    _, m = mul_wide(lo, qinv_neg)
    mq_hi, _ = mul_wide(m, q)
    r = hi + mq_hi + (lo != 0).to(hi.dtype)
    return torch.where(r >= q, r - q, r)


def to_mont_int(x: int, p: int) -> int:
    """x·R mod p for a python int (host-side table construction)."""
    return (x % p) * ((1 << 32) % p) % p


def qinv_neg32(p: int) -> int:
    return (-pow(p, -1, 1 << 32)) % (1 << 32)


def as_i32(values, device) -> torch.Tensor:
    """u32 values (python ints, possibly nested lists) -> int32 tensor
    with the same bit pattern."""
    arr = np.asarray(values, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(arr.view(np.int32)).to(device)


def u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> int64 holding the unsigned value."""
    return t.to(torch.int64) & MASK32
