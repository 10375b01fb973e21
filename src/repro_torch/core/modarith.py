"""Modular arithmetic for RNS-CKKS on int64 tensors.

Every residue is an int64 holding a value reduced mod a prime below 2^32
(the reference's "word32" limbs). Sums of two residues stay below 2^33.
A product of two can reach 2^64, past int64, because the prime search
(core/params.py) may return a 32-bit special prime (paper_params_bootstrap
draws 3221225473), so `mulmod` splits one operand into 16-bit halves and
every intermediate stays below 2^49. It equals the reference's uint64
``(a * b) % q`` exactly.

Shapes: data ``(..., L, N)``; per-limb constants broadcast by the caller
(``q[:, None]``), exactly as in the reference.

Beside the generic `mulmod`, the reduction strategies that
benchmarks/fig14_kernels.py times (Barrett, Montgomery with R = 2^32,
Solinas shift-add folding). The reference forms them in uint64 and relies
on its wrap-around; here every product of two 32-bit words is split with
`mul_wide`, so no intermediate passes 2^63. They take q < 2^31, as the
reference's do: then a product of two residues is below 2^62.
"""
from __future__ import annotations

import numpy as np
import torch


def to_i64(x) -> torch.Tensor:
    """Residues (a tensor, a numpy array of any integer dtype, python ints)
    as the int64 tensor the port computes on: the counterpart of the
    reference's ``to_u64``, since CPU torch has no uint64 ``%``. Values
    must lie below 2^63 (residues are below 2^32)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64)
    arr = np.asarray(x)
    if arr.dtype == np.uint64 and arr.size and int(arr.max()) >= 1 << 63:
        raise ValueError("a value of 2^63 or more does not fit int64")
    return torch.from_numpy(np.ascontiguousarray(arr.astype(np.int64)))


def addmod(a: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    r = a + b
    return torch.where(r >= q, r - q, r)


def submod(a: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    return torch.where(a >= b, a - b, a + (q - b))


def negmod(a: torch.Tensor, q) -> torch.Tensor:
    return torch.where(a == 0, a, q - a)


def mulmod(a: torch.Tensor, b, q) -> torch.Tensor:
    """(a * b) mod q for 0 <= a, b < q < 2^32."""
    return ((a * (b >> 16)) % q * 65536 + a * (b & 0xFFFF)) % q


def powmod_scalar(a: int, e: int, q: int) -> int:
    return pow(int(a), int(e), int(q))


MASK32 = 0xFFFFFFFF


def mul_wide(a, b):
    """(hi, lo) 32-bit words of a*b for 0 <= a, b < 2^32, on int64
    without overflow: b is split in 16-bit halves, every partial product
    stays below 2^48."""
    x = a * (b & 0xFFFF)
    y = a * (b >> 16)                     # a*b = x + y * 2^16
    lo_sum = (x & MASK32) + ((y & 0xFFFF) << 16)
    return (x >> 32) + (y >> 16) + (lo_sum >> 32), lo_sum & MASK32


def _mul128(a, b):
    """a*b for 0 <= a, b < 2^63 as (bits 64+, bits 32-63, bits 0-31)."""
    a0, a1 = a & MASK32, a >> 32
    b0, b1 = b & MASK32, b >> 32
    ll_hi, ll_lo = mul_wide(a0, b0)
    lh_hi, lh_lo = mul_wide(a0, b1)
    hl_hi, hl_lo = mul_wide(a1, b0)
    mid = ll_hi + lh_lo + hl_lo                       # < 3 * 2^32
    return a1 * b1 + lh_hi + hl_hi + (mid >> 32), mid & MASK32, ll_lo


def mulhi64(a, b):
    """High 64 bits of the 128-bit product a*b (0 <= a, b < 2^63)."""
    return _mul128(a, b)[0]


# ---------------------------------------------------------------------------
# Barrett (q < 2^31; mu = floor(2^62 / q))
# ---------------------------------------------------------------------------

def barrett_mu(q: int) -> int:
    return (1 << 62) // int(q)


def mulmod_barrett(a, b, q, mu):
    """(a*b) mod q via Barrett; a, b reduced, q < 2^31."""
    t = a * b
    hi, mid, _ = _mul128(t, mu)
    est = (hi << 2) | (mid >> 30)                     # floor(t*mu / 2^62)
    r = t - est * q
    r = torch.where(r >= q, r - q, r)
    return torch.where(r >= q, r - q, r)


# ---------------------------------------------------------------------------
# Montgomery (R = 2^32, odd q < 2^31)
# ---------------------------------------------------------------------------

def mont_qinv_neg(q: int) -> int:
    """-q^{-1} mod 2^32."""
    return (-pow(int(q), -1, 1 << 32)) % (1 << 32)


def mont_r2(q: int) -> int:
    """R^2 mod q with R = 2^32."""
    return (1 << 64) % int(q)


def mont_reduce(t, q, qinv_neg):
    """REDC: t < q*2^32 -> t*2^-32 mod q (result < q). The low words of t
    and m*q sum to 0 or exactly 2^32, so the sum is formed from the high
    words (carry iff t's low word is not 0) and never passes 2^63."""
    lo = t & MASK32
    _, m = mul_wide(lo, qinv_neg)
    mq_hi, _ = mul_wide(m, q)
    r = (t >> 32) + mq_hi + (lo != 0).to(t.dtype)
    return torch.where(r >= q, r - q, r)


def mont_mul(a, b, q, qinv_neg):
    """a*b*2^-32 mod q for a, b < q < 2^31."""
    return mont_reduce(a * b, q, qinv_neg)


def to_mont(a, q, qinv_neg, r2):
    return mont_mul(a, r2, q, qinv_neg)


def from_mont(a, q, qinv_neg):
    return mont_reduce(a, q, qinv_neg)


# ---------------------------------------------------------------------------
# Solinas shift-add reduction for q = 2^b - 2^s + 1: 2^b = 2^s - 1 (mod q)
# ---------------------------------------------------------------------------

def solinas_reduce(t, q, b: int, s: int):
    """Reduce t < 2^63 modulo q = 2^b - 2^s + 1 with shift/add folding."""
    mask = (1 << b) - 1
    # three folds always suffice for t < 2^63, b >= 20, s <= b-8
    for _ in range(3):
        hi = t >> b
        t = (t & mask) + (hi << s) - hi
    t = torch.where(t >= q, t - q, t)
    return torch.where(t >= q, t - q, t)


def mulmod_solinas(a, b_op, q, b: int, s: int):
    return solinas_reduce(a * b_op, q, b, s)
