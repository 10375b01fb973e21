"""CKKS bootstrapping: ModRaise -> CoefToSlot -> EvalMod -> SlotToCoef,
op for op the reference's `repro/core/bootstrap.py`.

This is the paper's flagship deep workload (§V-B "Bootstrapping", and the
CoefToSlot pipeline of Fig. 10). Full-slot (Han-Ki style) flow:

1. ModRaise: reinterpret a level-0 ciphertext at level L; the hidden message
   becomes t = m + q0*I with small integer polynomial I (sparse secret).
2. CoefToSlot: homomorphic linear transform moving coefficients into slots,
   packed z_j = (c_j + i*c_{j+N/2})/Delta — one ciphertext.
3. EvalMod: approximate t -> t mod q0 via the scaled sine
   (q0/2pi) sin(2pi t/q0), evaluated with Chebyshev interpolation on the
   real and imaginary parts separately.
4. SlotToCoef: inverse linear transform.

The transform matrices are the canonical embedding's, built densely and
inverted in numpy float64 on the host exactly as the reference does, so
their diagonals (and the plaintexts encoded from them) are bit-equal to
the reference's. The dense n x n inverse bounds the ring this can run at
(64 GiB of complex128 at log N = 16), and its diagonals, encoded at the
ciphertext's scale, bound its precision as the ring grows. Keys are drawn
in the reference's order (Galois keys for the sorted elements, then the
relinearization key), so a seeded encryptor gives bit-equal keys; that
includes the unused giant-step keys `matvec_keys_needed` asks for.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.core import linalg, ops as hops
from repro_torch.core.ciphertext import Ciphertext, KeySwitchKey
from repro_torch.core.context import CkksContext, to_device
from repro_torch.core.encoder import CkksEncoder


@dataclasses.dataclass
class BootstrapConfig:
    eval_mod_degree: int = 31     # Chebyshev degree for sin
    k_range: float = 12.0         # |t/q0| bound (depends on secret hamming wt)
    cts_level_cost: int = 1
    stc_level_cost: int = 1


class Bootstrapper:

    def __init__(self, ctx: CkksContext, encoder: CkksEncoder,
                 encryptor, sk, config: Optional[BootstrapConfig] = None):
        self.ctx = ctx
        self.encoder = encoder
        self.config = config or BootstrapConfig()
        n = ctx.n
        s = n // 2
        # canonical embedding matrix V (s x n): v_j = sum_k c_k zeta^{k e_j}
        k = np.arange(n)
        V = np.exp(1j * np.pi * np.outer(encoder.slot_exp, k) / n)
        W = np.vstack([V, np.conj(V)])           # (n, n)
        Winv = np.linalg.inv(W)                  # c = Winv @ [v; conj v]
        P, Q = Winv[:, :s], Winv[:, s:]          # (n, s) each
        self.A_cts = P[:s] + 1j * P[s:]          # z = A v + B conj(v)
        self.B_cts = Q[:s] + 1j * Q[s:]
        V_L, V_R = V[:, :s], V[:, s:]
        self.A_stc = 0.5 * (V_L - 1j * V_R)      # v = A' z + B' conj(z)
        self.B_stc = 0.5 * (V_L + 1j * V_R)
        self.diags_A_cts = linalg.matrix_diagonals(self.A_cts)
        self.diags_B_cts = linalg.matrix_diagonals(self.B_cts)
        self.diags_A_stc = linalg.matrix_diagonals(self.A_stc)
        self.diags_B_stc = linalg.matrix_diagonals(self.B_stc)
        # keys, in the reference's draw order
        elts = set()
        for dg in (self.diags_A_cts, self.diags_B_cts,
                   self.diags_A_stc, self.diags_B_stc):
            elts.update(linalg.matvec_keys_needed(ctx, dg))
        elts.add(ctx.conj_element)
        self.gks: Dict[int, KeySwitchKey] = encryptor.galois_keygen(
            sk, sorted(elts))
        self.rk: KeySwitchKey = encryptor.relin_keygen(sk)
        # Chebyshev coefficients of sin(2*pi*K*y) on y in [-1, 1]
        kk = self.config.k_range
        self.cheb = linalg.chebyshev_coeffs(
            lambda y: np.sin(2 * np.pi * kk * y), self.config.eval_mod_degree)

    # -- stages --------------------------------------------------------------

    def mod_raise(self, ct: Ciphertext, target_level: int) -> Ciphertext:
        """Level-0 ciphertext -> target_level; message becomes m + q0*I.
        The centring and the per-prime reduction are host int64 steps, as
        in the reference; the forward NTT runs on the context's device."""
        assert ct.level == 0
        ctx = self.ctx
        q0 = ctx.primes[0]
        coeff = ctx.intt(ct.data, [0]).cpu().numpy()[..., 0, :]  # (..., 2, N)
        centered = np.where(coeff > q0 // 2, coeff - q0, coeff)
        idx = ctx.q_idx(target_level)
        primes = np.array([ctx.primes[i] for i in idx], dtype=np.int64)
        limbs = centered[..., None, :] % primes[:, None]
        data = ctx.ntt(to_device(limbs, ctx.device), idx)
        return Ciphertext(data, target_level, ct.scale)

    def _transform(self, ct: Ciphertext, diags_a, diags_b) -> Ciphertext:
        """out = A ct + B conj(ct); B is exactly zero for the packed
        (c_low + i c_high) CtS/StC matrices — the packing makes them
        C-linear — but we keep the general form."""
        ctx, enc = self.ctx, self.encoder
        out = linalg.matvec_bsgs(ctx, ct, diags_a, self.gks, enc)
        if diags_b:
            ct_conj = hops.conjugate(ctx, ct, self.gks[ctx.conj_element])
            zb = linalg.matvec_bsgs(ctx, ct_conj, diags_b, self.gks, enc)
            zb.scale = out.scale
            out = hops.hadd(ctx, out, zb)
        return out

    def coef_to_slot(self, ct: Ciphertext) -> Ciphertext:
        return self._transform(ct, self.diags_A_cts, self.diags_B_cts)

    def slot_to_coef(self, ct: Ciphertext) -> Ciphertext:
        return self._transform(ct, self.diags_A_stc, self.diags_B_stc)

    def eval_mod(self, ct: Ciphertext, q0_over_scale: float) -> Ciphertext:
        """Input slots: t/Delta (t = m + q0 I). Output slots: ~ m/Delta."""
        ctx, enc = self.ctx, self.encoder
        kk = self.config.k_range
        # y = t / (q0 * K) in [-1, 1]
        y = linalg.mul_const(ctx, enc, ct, 1.0 / (q0_over_scale * kk))
        g = linalg.poly_eval_chebyshev(ctx, y, self.cheb, self.rk, enc)
        # m/Delta ~= (q0/Delta) * sin(2 pi t / q0) / (2 pi)
        return linalg.mul_const(ctx, enc, g, q0_over_scale / (2 * np.pi))

    # -- full pipeline ---------------------------------------------------------

    def bootstrap(self, ct: Ciphertext, target_level: int) -> Ciphertext:
        """level-0 -> refreshed ciphertext at a usable level."""
        ctx = self.ctx
        q0 = ctx.primes[0]
        raised = self.mod_raise(ct, target_level)
        z = self.coef_to_slot(raised)
        # split real/imag
        z_conj = hops.conjugate(ctx, z, self.gks[ctx.conj_element])
        z_conj.scale = z.scale
        re = hops.hadd(ctx, z, z_conj)
        re = linalg.mul_const(ctx, self.encoder, re, 0.5)
        im = hops.hsub(ctx, z, z_conj)
        im = linalg.mul_const(ctx, self.encoder, im, -0.5j)
        q0_over_scale = q0 / ct.scale
        re_m = self.eval_mod(re, q0_over_scale)
        im_m = self.eval_mod(im, q0_over_scale)
        im_i = linalg.mul_const(ctx, self.encoder, im_m, 1j)
        re_m = linalg.adjust_to(ctx, self.encoder, re_m, im_i.level, im_i.scale)
        z2 = hops.hadd(ctx, re_m, im_i)
        out = self.slot_to_coef(z2)
        return out
