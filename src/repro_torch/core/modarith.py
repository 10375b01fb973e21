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
"""
from __future__ import annotations

import torch


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


def mont_qinv_neg(q: int) -> int:
    """-q^{-1} mod 2^32."""
    return (-pow(int(q), -1, 1 << 32)) % (1 << 32)


def mont_r2(q: int) -> int:
    """R^2 mod q with R = 2^32."""
    return (1 << 64) % int(q)


def barrett_mu(q: int) -> int:
    return (1 << 62) // int(q)
