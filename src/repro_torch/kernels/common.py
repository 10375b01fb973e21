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

from repro_torch.core.modarith import MASK32, mul_wide
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


# ---------------------------------------------------------------------------
# the radix-pass schedule of csrc/common.cuh (rt::Sched), on the CPU
# ---------------------------------------------------------------------------
# The NTT kernels (K1-K3 per chunk of a row, K7's ntt_col per column) give
# an NTT of C = 2^log_c points to C / 16 threads holding 16 values each and
# run its stages as radix passes in registers. These are Sched's index
# formulas; the models built from them (keyswitch.ntt_fwd_sched,
# keyswitch.intt_sched, ntt.ntt_col_sched) hold them to the plain NTTs.

SCHED_VALS = 16         # values one thread holds (csrc/common.cuh kVals)


def sched_phys(p):
    """Padded shared-memory word of chunk position p: 4 pad words after
    every 64, so that no access of the schedule hits a bank twice."""
    return p + ((p >> 6) << 2)


def sched_passes(log_c: int):
    """(first local stage, radix log) of each in-chunk pass: radix-16
    passes from the top, the last one takes the remaining 1-4 stages.
    The inverse NTT runs them in the opposite order."""
    last = (log_c - 1) % 4 + 1
    return ([(st, 4) for st in range(0, log_c - last, 4)]
            + [(log_c - last, last)])


def sched_run_pos(log_c: int, tid, j):
    """Position of value j of thread tid in the BConv phase and the
    epilogues: four runs of 4 contiguous words."""
    threads = 1 << (log_c - 4)
    return ((tid + threads * (j >> 2)) << 2) + (j & 3)


def sched_pos(log_c: int, st: int, lr: int, tid, j):
    """(position, set) of value j of thread tid in the pass that starts
    at local stage st with radix 2^lr. A radix-16 pass above the last
    holds 16 values at the stride of its last stage; the last pass holds
    16 / 2^lr sets of 2^lr contiguous values."""
    if st + lr < log_c:
        kq = 1 << (log_c - st - 4)
        blk = tid >> (log_c - st - 4)
        pos = (blk << (log_c - st)) + (tid & (kq - 1)) + j * kq
        return pos, blk + 0 * j
    blk = tid + (1 << (log_c - 4)) * (j >> lr)
    return (blk << lr) + (j & ((1 << lr) - 1)), blk


def sched_radix(y, rp, q, qi, nch, c, st, lr, blk, inverse=False):
    """lr butterfly stages on the values of each thread (the last axis of
    y, sets of 2^lr), twiddle rp[m + c·2^(st+s) + blk·2^s + h] at stage s:
    Harvey CT from the largest stride down, or (inverse) Gentleman-Sande
    from the smallest stride up, as csrc/common.cuh::radix_stage."""
    jj = torch.arange(y.shape[-1])
    r = 1 << lr
    y = y.clone()
    for s in (reversed(range(lr)) if inverse else range(lr)):
        half = r >> (s + 1)
        lo = jj[(jj & half) == 0]
        hi = lo + half
        h = (lo & (r - 1)) >> (lr - s)
        w = rp[:, (nch << (st + s)) + (c << (st + s)) + (blk[:, lo] << s)
               + h]
        u, v = y[..., lo], y[..., hi]
        if inverse:
            y[..., lo] = addmod32(u, v, q)
            y[..., hi] = mont_mul32(submod32(u, v, q), w, q, qi)
        else:
            v = mont_mul32(v, w, q, qi)
            y[..., lo], y[..., hi] = addmod32(u, v, q), submod32(u, v, q)
    return y
