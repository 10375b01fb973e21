"""Ciphertext / plaintext / key containers.

All polynomials live in the NTT (evaluation) domain in bit-reversed
order (see core/ntt.py), as int64 RNS limbs on the context's device:

    Ciphertext.data   : (2, level+1, N)   [0]=b, [1]=a;  Dec = b + a*s
    KeySwitchKey.data : (dnum, 2, n_q + n_p, N)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class Ciphertext:
    data: torch.Tensor          # (2, level+1, N) int64, NTT domain
    level: int
    scale: float

    @property
    def n_limbs(self) -> int:
        return self.level + 1

    def copy(self) -> "Ciphertext":
        return Ciphertext(self.data, self.level, self.scale)


@dataclasses.dataclass
class Plaintext:
    data: torch.Tensor          # (level+1, N) int64, NTT domain
    level: int
    scale: float


@dataclasses.dataclass
class SecretKey:
    s_ntt: torch.Tensor         # (n_q + n_p, N) NTT domain under all moduli
    s_coeff_ternary: Optional[torch.Tensor] = None  # (N,) int8 (tests only)


@dataclasses.dataclass
class PublicKey:
    data: torch.Tensor          # (2, n_q, N) at full Q basis


@dataclasses.dataclass
class KeySwitchKey:
    """Generalized (dnum-digit) key-switching key: enc of g_d * s_src."""
    data: torch.Tensor          # (dnum, 2, n_q + n_p, N)
