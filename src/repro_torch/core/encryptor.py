"""Key generation, encryption, decryption for full-RNS CKKS.

Sampling runs on the host with ``np.random.default_rng(seed)`` in exactly
the reference's draw order, so keys and ciphertexts are bit-identical to
`repro.core.encryptor` for the same seed; the arithmetic on the samples
runs on the context's device.

* uniform ring elements are sampled directly in the NTT domain, limb-wise;
* small elements (secret, errors) are integer coefficient vectors,
  reduced per limb, then NTT'd.

Key-switching keys implement the generalized (Han–Ki) gadget: for digit d
with modulus group Q_d, g_d = P * Qhat_d * [Qhat_d^{-1}]_{Q_d}, and
ksk_d = (-a_d s + e_d + g_d * s_src , a_d).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import modarith as ma
from repro_torch.core.ciphertext import (Ciphertext, KeySwitchKey, Plaintext,
                                         PublicKey, SecretKey)
from repro_torch.core.context import CkksContext, to_device


class CkksEncryptor:

    def __init__(self, ctx: CkksContext, seed: int = 2024):
        self.ctx = ctx
        self.rng = np.random.default_rng(seed)

    # -- sampling (host) -----------------------------------------------------

    def _sample_uniform_ntt(self, idx: Sequence[int],
                            shape_prefix=()) -> torch.Tensor:
        primes = np.array([self.ctx.primes[i] for i in idx], dtype=np.uint64)
        out = np.empty(shape_prefix + (len(idx), self.ctx.n), dtype=np.uint64)
        for k, p in enumerate(primes):
            out[..., k, :] = self.rng.integers(
                0, p, size=shape_prefix + (self.ctx.n,), dtype=np.uint64)
        return to_device(out, self.ctx.device)

    def _sample_error_coeff(self) -> np.ndarray:
        return np.round(self.rng.normal(0.0, self.ctx.params.error_std,
                                        size=self.ctx.n)).astype(np.int64)

    def _sample_ternary_coeff(self, hamming: Optional[int] = None
                              ) -> np.ndarray:
        n = self.ctx.n
        h = hamming or self.ctx.params.hamming_weight_sk
        s = np.zeros(n, dtype=np.int64)
        pos = self.rng.choice(n, size=h, replace=False)
        s[pos] = self.rng.choice(np.array([-1, 1]), size=h)
        return s

    def _small_to_ntt(self, coeffs: np.ndarray,
                      idx: Sequence[int]) -> torch.Tensor:
        primes = np.array([self.ctx.primes[i] for i in idx], dtype=np.int64)
        limbs = coeffs[None, :] % primes[:, None]
        return self.ctx.ntt(to_device(limbs, self.ctx.device), idx)

    # -- keygen -------------------------------------------------------------

    def keygen(self) -> SecretKey:
        s = self._sample_ternary_coeff()
        all_idx = list(range(self.ctx.n_q + self.ctx.n_p))
        return SecretKey(s_ntt=self._small_to_ntt(s, all_idx),
                         s_coeff_ternary=torch.from_numpy(
                             s.astype(np.int8)).to(self.ctx.device))

    def public_keygen(self, sk: SecretKey) -> PublicKey:
        idx = self.ctx.q_idx(self.ctx.params.n_levels)
        q = self.ctx.q_all[: len(idx)][:, None]
        a = self._sample_uniform_ntt(idx)
        e = self._small_to_ntt(self._sample_error_coeff(), idx)
        s = sk.s_ntt[: len(idx)]
        b = ma.submod(e, ma.mulmod(a, s, q), q)
        return PublicKey(data=torch.stack([b, a]))

    def _ksk_gen(self, sk: SecretKey, target_ntt: torch.Tensor
                 ) -> KeySwitchKey:
        """KSK switching FROM the key whose full-basis NTT rep is
        target_ntt TO sk. target_ntt: (n_q+n_p, N)."""
        ctx = self.ctx
        q = ctx.q_all[:, None]
        s = sk.s_ntt
        big_q_full = 1
        for p in ctx.q_primes:
            big_q_full *= p
        ksk = []
        for J in ctx.params.digit_indices(ctx.params.n_levels):
            q_d = 1
            for j in J:
                q_d *= ctx.q_primes[j]
            qhat_d = big_q_full // q_d
            g_d = ctx.big_p * qhat_d * pow(qhat_d % q_d, -1, q_d)
            g_limbs = ctx._t([g_d % p for p in ctx.primes])
            a = self._sample_uniform_ntt(range(len(ctx.primes)))
            e = self._small_to_ntt(self._sample_error_coeff(),
                                   range(len(ctx.primes)))
            body = ma.mulmod(target_ntt, g_limbs[:, None], q)
            b = ma.addmod(ma.submod(e, ma.mulmod(a, s, q), q), body, q)
            ksk.append(torch.stack([b, a]))
        return KeySwitchKey(data=torch.stack(ksk))

    def relin_keygen(self, sk: SecretKey) -> KeySwitchKey:
        q = self.ctx.q_all[:, None]
        return self._ksk_gen(sk, ma.mulmod(sk.s_ntt, sk.s_ntt, q))

    def galois_keygen(self, sk: SecretKey,
                      elements: Sequence[int]) -> Dict[int, KeySwitchKey]:
        """Keys for sigma_k(s) -> s, per Galois element k."""
        return {k: self._ksk_gen(sk, sk.s_ntt[:, self.ctx.eval_perm(k)])
                for k in elements}

    def rotation_keygen(self, sk: SecretKey,
                        steps: Sequence[int]) -> Dict[int, KeySwitchKey]:
        elts = sorted({self.ctx.rotation_element(st) for st in steps})
        return self.galois_keygen(sk, elts)

    # -- encrypt / decrypt ---------------------------------------------------

    def encrypt_sk(self, pt: Plaintext, sk: SecretKey) -> Ciphertext:
        idx = self.ctx.q_idx(pt.level)
        q = self.ctx.q_all[: len(idx)][:, None]
        a = self._sample_uniform_ntt(idx)
        e = self._small_to_ntt(self._sample_error_coeff(), idx)
        s = sk.s_ntt[: len(idx)]
        b = ma.addmod(ma.submod(e, ma.mulmod(a, s, q), q), pt.data, q)
        return Ciphertext(torch.stack([b, a]), pt.level, pt.scale)

    def encrypt_pk(self, pt: Plaintext, pk: PublicKey) -> Ciphertext:
        idx = self.ctx.q_idx(pt.level)
        n_limbs = len(idx)
        q = self.ctx.q_all[:n_limbs][:, None]
        u = self._small_to_ntt(self._sample_ternary_coeff(), idx)
        e0 = self._small_to_ntt(self._sample_error_coeff(), idx)
        e1 = self._small_to_ntt(self._sample_error_coeff(), idx)
        b = ma.addmod(ma.addmod(ma.mulmod(pk.data[0, :n_limbs], u, q), e0,
                                q), pt.data, q)
        a = ma.addmod(ma.mulmod(pk.data[1, :n_limbs], u, q), e1, q)
        return Ciphertext(torch.stack([b, a]), pt.level, pt.scale)

    def decrypt(self, ct: Ciphertext, sk: SecretKey) -> Plaintext:
        n_limbs = ct.level + 1
        q = self.ctx.q_all[:n_limbs][:, None]
        m = ma.addmod(ct.data[0],
                      ma.mulmod(ct.data[1], sk.s_ntt[:n_limbs], q), q)
        return Plaintext(m, ct.level, ct.scale)
