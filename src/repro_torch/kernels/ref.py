"""Exact oracles for the kernels K4-K7, on int64 tensors and numpy.

The port's copy of `repro/kernels/ref.py`. These define what the kernels
compute; the plain versions and the tests are held to them bit for bit.
Arithmetic goes through `core/modarith.mulmod` (16-bit split), so it is
exact for moduli up to 2^32, the 32-bit special prime included.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import modarith as ma
from repro_torch.core import ntt as nttm


def modmul_ref(a, b, q):
    """Elementwise (a*b) mod q. a, b: (L, N) int64; q: (L,)."""
    return ma.mulmod(a, b, q[:, None])


def fused_mulacc_ref(a, b, c, q):
    """(a*b + c) mod q, the NMU multiply-accumulate."""
    q = q[:, None]
    return ma.addmod(ma.mulmod(a, b, q), c % q, q)


def bconv_ref(v, w, p):
    """BConv accumulation: out[d, n] = sum_j v[j, n] * w[j, d] mod p[d].

    v: (S, N), w: (S, D), p: (D,), all < 2^32; every term is reduced before
    the sum, so the sum stays below S * 2^32.
    """
    acc = torch.zeros((w.shape[1], v.shape[1]), dtype=torch.int64,
                      device=v.device)
    for j in range(v.shape[0]):
        acc = acc + ma.mulmod(v[j][None, :], w[j][:, None], p[:, None])
    return acc % p[:, None]


# ---------------------------------------------------------------------------
# four-step negacyclic NTT reference (kernel ordering)
# ---------------------------------------------------------------------------

class FourStepTables:
    """Host tables (numpy int64) for the (R x C) four-step negacyclic NTT.

    hat a_k = sum_j a_j psi^j omega^{jk}, omega = psi^2, j = r*C + c.
    Split k = ku + R*kv:
        phase 1: column negacyclic NTT with root psi_col = psi^C; Harvey
            CT butterflies include the psi_col^r twist and leave slot u
            holding cyclic column index brv_R(u);
        phase 2: elementwise correction T2[u, c] = psi^c * omega^{c*brv_R(u)};
        phase 3: row cyclic DFT of size C via negacyclic CT with root
            psi_row = psi^R and an inverse pre-twist psi_row^{-c}.

    Kernel output order: out[u, v] = hat a at k = brv_R(u) + R * brv_C(v).
    The tables equal the reference's; T2 is built row by row with
    `power_table` (log C vector products a row) instead of 2N scalar
    `pow` calls, so N = 2^16 costs milliseconds, not seconds.
    """

    def __init__(self, q: int, psi: int, log_n: int, log_r: int):
        n = 1 << log_n
        r = 1 << log_r
        c = n // r
        self.q, self.n, self.r, self.c = q, n, r, c
        omega = psi * psi % q
        psi_col = pow(psi, c, q)      # 2R-th root (psi_col^R = psi^N = -1)
        psi_row = pow(psi, r, q)      # 2C-th root
        brv_r = nttm.bit_reverse_vector(r)
        brv_c = nttm.bit_reverse_vector(c)
        self.brv_r, self.brv_c = brv_r, brv_c
        self.rp_col = nttm.power_table(psi_col, q, r)[brv_r].astype(np.int64)
        self.rp_row = nttm.power_table(psi_row, q, c)[brv_c].astype(np.int64)
        psi_pow = nttm.power_table(psi, q, c)
        qq = np.uint64(q)
        self.t2 = np.stack([
            psi_pow * nttm.power_table(pow(omega, int(eu), q), q, c) % qq
            for eu in brv_r]).astype(np.int64)
        self.pre_row_inv = nttm.power_table(pow(psi_row, -1, q), q,
                                            c).astype(np.int64)
        # fuse T2 and the row pre-twist into one elementwise table
        self.t2_fused = (self.t2.astype(np.uint64)
                         * self.pre_row_inv[None, :].astype(np.uint64)
                         % qq).astype(np.int64)

    def output_index_map(self) -> np.ndarray:
        """k such that out.flatten()[u*C + v] = hat a_k."""
        return (self.brv_r[:, None] + self.r * self.brv_c[None, :]).reshape(-1)


def four_step_ntt_ref(a: torch.Tensor, tabs: FourStepTables) -> torch.Tensor:
    """Reference four-step negacyclic NTT (kernel ordering). a: (N,) int64."""
    dev = a.device
    q = torch.tensor([tabs.q], dtype=torch.int64, device=dev)
    r, c = tabs.r, tabs.c
    x = a.reshape(r, c)
    # phase 1: column negacyclic NTT (CT includes the twist)
    xt = x.T.reshape(c, 1, r)
    y = nttm.ntt_forward(xt, torch.from_numpy(tabs.rp_col).to(dev)[None], q)
    y = y.reshape(c, r).T
    # phase 2: fused correction + row pre-twist
    y = ma.mulmod(y, torch.from_numpy(tabs.t2_fused).to(dev), q)
    # phase 3: row negacyclic NTT (= cyclic DFT thanks to the pre-twist)
    z = nttm.ntt_forward(y.reshape(r, 1, c),
                         torch.from_numpy(tabs.rp_row).to(dev)[None], q)
    return z.reshape(r * c)


def naive_negacyclic_eval(a: np.ndarray, q: int, psi: int) -> np.ndarray:
    """hat a_k = sum_j a_j psi^{j(2k+1)} (Python ints; small N only)."""
    n = len(a)
    out = np.empty(n, dtype=np.int64)
    for k in range(n):
        base = pow(psi, 2 * k + 1, q)
        acc, p = 0, 1
        for j in range(n):
            acc = (acc + int(a[j]) * p) % q
            p = p * base % q
        out[k] = acc
    return out
