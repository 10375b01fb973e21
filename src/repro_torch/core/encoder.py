"""CKKS canonical-embedding encoder/decoder (SIMD slot packing).

Encode and decode run the float FFT on the host in numpy float64, as
the reference does; the RNS limbs go to and come from the context's
device. Decode is the one place the port is held to a tolerance rather
than bit equality (tests/test_torch_core.py).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core import rns
from repro_torch.core.context import CkksContext, to_device


class CkksEncoder:

    def __init__(self, ctx: CkksContext):
        self.ctx = ctx
        n = ctx.n
        self.n = n
        self.slots = n // 2
        two_n = 2 * n
        # slot j <-> odd exponent 5^j mod 2N; conjugate slot at 2N - 5^j
        e = 1
        slot_exp = np.empty(self.slots, dtype=np.int64)
        for j in range(self.slots):
            slot_exp[j] = e
            e = (e * 5) % two_n
        self.slot_exp = slot_exp
        self.slot_t = (slot_exp - 1) // 2            # position in odd-DFT order
        self.conj_t = ((two_n - slot_exp) - 1) // 2
        k = np.arange(n)
        self.zeta_pow = np.exp(1j * np.pi * k / n)   # zeta^k
        self.zeta_pow_inv = np.conj(self.zeta_pow)

    # -- float coefficient domain <-> slots ---------------------------------

    def embed_inverse(self, v: np.ndarray) -> np.ndarray:
        """Slots -> real coefficient vector (unscaled float64)."""
        assert v.shape[-1] == self.slots
        vals = np.zeros(v.shape[:-1] + (self.n,), dtype=np.complex128)
        vals[..., self.slot_t] = v
        vals[..., self.conj_t] = np.conj(v)
        twisted = np.fft.fft(vals, axis=-1) / self.n
        m = twisted * self.zeta_pow_inv
        return np.real(m)

    def embed_forward(self, m: np.ndarray) -> np.ndarray:
        """Real coefficients -> slots (float64 -> complex128)."""
        twisted = m.astype(np.complex128) * self.zeta_pow
        vals = np.fft.ifft(twisted, axis=-1) * self.n
        return vals[..., self.slot_t]

    # -- RNS plaintexts ------------------------------------------------------

    def encode(self, v: Sequence[complex], scale: float,
               level: int) -> torch.Tensor:
        """Complex slots -> RNS plaintext (level+1, N) in NTT domain."""
        v = np.asarray(v, dtype=np.complex128)
        if v.ndim == 0:
            v = np.full(self.slots, complex(v))
        if v.shape[-1] != self.slots:
            full = np.zeros(self.slots, dtype=np.complex128)
            full[: v.shape[-1]] = v
            v = full
        coeffs = np.round(self.embed_inverse(v) * scale).astype(np.int64)
        return self.to_rns_ntt(coeffs, level)

    def to_rns_ntt(self, coeffs: np.ndarray, level: int) -> torch.Tensor:
        """Signed int64 coefficients -> (level+1, N) NTT-domain RNS limbs."""
        idx = self.ctx.q_idx(level)
        primes = np.array([self.ctx.primes[i] for i in idx], dtype=np.int64)
        limbs = coeffs[None, :] % primes[:, None]
        return self.ctx.ntt(to_device(limbs, self.ctx.device), idx)

    def decode(self, pt_ntt: torch.Tensor, scale: float,
               level: int) -> np.ndarray:
        """(level+1, N) NTT-domain plaintext -> complex slots (host)."""
        idx = self.ctx.q_idx(level)
        coeff = self.ctx.intt(pt_ntt, idx).cpu().numpy()
        primes = [self.ctx.primes[i] for i in idx]
        if len(primes) == 1:
            q = primes[0]
            c = coeff[0]
            c = np.where(c > q // 2, c - q, c).astype(np.float64)
        else:
            lifted = rns.crt_lift_centered(coeff, primes)
            c = np.array([float(x) for x in lifted])
        return self.embed_forward(c / scale)
