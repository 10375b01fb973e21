"""Public wrappers around the kernels that take u64-style residues and
primes: Montgomery conversion of the constant operand and the per-basis
constants, mirroring `repro/kernels/ops.py`.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple

import torch

from repro_torch.core import modarith as ma
from repro_torch.kernels import bconv as bconv_k
from repro_torch.kernels import modmul as modmul_k
from repro_torch.kernels.common import as_i32, qinv_neg32, record_dispatch
from repro_torch.kernels.ntt import FourStepKernelTables, ntt_four_step
from repro_torch.kernels.ref import FourStepTables


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


def _b_mont(b: torch.Tensor, primes: Sequence[int]):
    """b (Rb, N) in Montgomery form w.r.t. its row's prime (int32), and
    the basis constants q32, -q^-1 the kernels take."""
    q64, q32, qinv, rm = _mont_consts(
        tuple(int(p) for p in primes), str(b.device))
    return ma.mulmod(b, rm[:, None], q64[:, None]).to(torch.int32), q32, qinv


def modmul(a: torch.Tensor, b: torch.Tensor,
           primes: Sequence[int]) -> torch.Tensor:
    """(a*b) mod q per limb row through K4. a: (R, N) int64; b: (Rb, N)
    int64 with R % Rb == 0 and primes of length Rb: row r of a pairs with
    row r % Rb of b and prime r % Rb."""
    record_dispatch()
    return modmul_k.modmul_mont(a.contiguous(), *_b_mont(b, primes))


def mulacc(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
           primes: Sequence[int]) -> torch.Tensor:
    """(a*b + c) mod q per limb row through K5; shapes and row pairing as
    `modmul`, c like a and reduced."""
    record_dispatch()
    b_mont, q32, qinv = _b_mont(b, primes)
    return modmul_k.mulacc_mont(a.contiguous(), b_mont, c.contiguous(), q32,
                                qinv)


def bconv(v: torch.Tensor, w: torch.Tensor, dst_primes: Sequence[int],
          lazy: bool = False) -> torch.Tensor:
    """out[d] = sum_j v[j]*w[j,d] mod p_d through K6. v: (S, N) int64, each
    row < 2^32; w: (S, D) int64 (reduced mod p_d here)."""
    p64, p32, pinv, rm = _mont_consts(
        tuple(int(p) for p in dst_primes), str(v.device))
    record_dispatch()
    w_mont = ma.mulmod(w.T % p64[:, None], rm[:, None],
                       p64[:, None]).to(torch.int32).contiguous()
    return bconv_k.bconv_mont(v.contiguous(), w_mont, p32, pinv, lazy=lazy)


class NttKernel:
    """Four-step NTT through K7, bound to one modulus. Host tables are
    built once; their Montgomery-form copy once per device."""

    def __init__(self, q: int, psi: int, log_n: int, log_r: int):
        self.tabs = FourStepTables(q, psi, log_n, log_r)
        self._kt = {}

    def tables(self, device) -> FourStepKernelTables:
        key = str(device)
        if key not in self._kt:
            self._kt[key] = FourStepKernelTables(self.tabs, device)
        return self._kt[key]

    def __call__(self, a: torch.Tensor, **blocks) -> torch.Tensor:
        """a: (N,) int64 -> (N,) int64 in kernel order (`FourStepTables`)."""
        record_dispatch(2)          # column kernel + fused row kernel
        return ntt_four_step(a.contiguous(), self.tables(a.device), **blocks)
