"""Public wrappers around the kernels that take u64-style residues and
primes: Montgomery conversion of the constant operand and the per-basis
constants, mirroring `repro/kernels/ops.py`.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple

import torch

from repro_torch.core import modarith as ma
from repro_torch.kernels import modmul as modmul_k
from repro_torch.kernels.common import as_i32, qinv_neg32, record_dispatch


@lru_cache(maxsize=256)
def _mont_consts(primes: Tuple[int, ...], device: str):
    """Per-prime-basis constants (q as int64 and as u32 bits, -q^-1 mod
    2^32, R mod q), cached on (primes, device) so no host work or
    host-to-device copy runs per call."""
    q64 = torch.tensor(primes, dtype=torch.int64, device=device)
    q32 = as_i32(primes, device)
    qinv = as_i32([qinv_neg32(p) for p in primes], device)
    rm = torch.tensor([(1 << 32) % p for p in primes], dtype=torch.int64,
                      device=device)
    return q64, q32, qinv, rm


def modmul(a: torch.Tensor, b: torch.Tensor,
           primes: Sequence[int]) -> torch.Tensor:
    """(a*b) mod q per limb row through K4. a: (R, N) int64; b: (Rb, N)
    int64 with R % Rb == 0 and primes of length Rb: row r of a pairs with
    row r % Rb of b and prime r % Rb."""
    q64, q32, qinv, rm = _mont_consts(
        tuple(int(p) for p in primes), str(a.device))
    record_dispatch()
    b_mont = ma.mulmod(b, rm[:, None], q64[:, None]).to(torch.int32)
    return modmul_k.modmul_mont(a.contiguous(), b_mont, q32, qinv)
