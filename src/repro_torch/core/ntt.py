"""Negacyclic NTT over RNS limbs on torch tensors.

Same conventions as the reference (`repro/core/ntt.py`):

* forward NTT: natural-order input -> bit-reversed evaluation domain
  (evaluations at odd powers of psi, psi a primitive 2N-th root);
* all elementwise ciphertext algebra happens in that domain;
* automorphisms there are pure permutations (``eval_perm``).

This is the library path (plain torch ops, one batched butterfly stage
at a time). The fused keyswitch kernels (kernels/keyswitch.py) run the
same butterflies on 32-bit Montgomery twiddles.

Data: ``(..., L, N)`` int64; per-limb constants ``(L,)``.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import modarith as ma
from repro_torch.core.params import Modulus, find_2nth_root


def bit_reverse_vector(n: int) -> np.ndarray:
    """[brv(i, log2 n) for i < n]: i with its log2(n) bits reversed."""
    bits = n.bit_length() - 1
    i = np.arange(n, dtype=np.int64)
    out = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        out |= ((i >> b) & 1) << (bits - 1 - b)
    return out


def power_table(base: int, p: int, n: int) -> np.ndarray:
    """[base^0, ..., base^(n-1)] mod p as uint64 (p < 2^32: exact)."""
    out = np.ones(n, dtype=np.uint64)
    size, step = 1, base % p
    while size < n:
        out[size:2 * size] = (out[:size] * np.uint64(step)) % np.uint64(p)
        size *= 2
        step = step * step % p
    return out


# ---------------------------------------------------------------------------
# table construction (host side, then one copy to the device)
# ---------------------------------------------------------------------------

class NttTables:
    """Per-modulus-set twiddle tables for ring degree N, on `device`.

    root_powers[l, i]     = psi_l^{brv(i, logN)}
    inv_root_powers[l, i] = psi_l^{-brv(i, logN)}
    """

    def __init__(self, moduli: Sequence[Modulus], log_n: int,
                 device: torch.device):
        self.log_n = log_n
        self.n = 1 << log_n
        self.moduli = tuple(moduli)
        brv = bit_reverse_vector(self.n)
        rp_list, irp_list, ninv_list, psi_list = [], [], [], []
        for mod in moduli:
            p = mod.value
            psi = find_2nth_root(p, 2 * self.n)
            rp_list.append(power_table(psi, p, self.n)[brv])
            irp_list.append(power_table(pow(psi, -1, p), p, self.n)[brv])
            ninv_list.append(pow(self.n, -1, p))
            psi_list.append(psi)
        q = [m.value for m in moduli]
        self.q = torch.tensor(q, dtype=torch.int64, device=device)
        self.root_powers = torch.from_numpy(
            np.stack(rp_list).astype(np.int64)).to(device)
        self.inv_root_powers = torch.from_numpy(
            np.stack(irp_list).astype(np.int64)).to(device)
        self.n_inv = torch.tensor(ninv_list, dtype=torch.int64,
                                  device=device)
        self.psi = tuple(psi_list)

    def slice_limbs(self, idx: Sequence[int]) -> "NttTables":
        """Tables of a subset of limbs (no recomputation)."""
        out = object.__new__(NttTables)
        out.log_n = self.log_n
        out.n = self.n
        idx = list(idx)
        out.moduli = tuple(self.moduli[i] for i in idx)
        ii = torch.tensor(idx, dtype=torch.int64, device=self.q.device)
        out.q = self.q[ii]
        out.root_powers = self.root_powers[ii]
        out.inv_root_powers = self.inv_root_powers[ii]
        out.n_inv = self.n_inv[ii]
        out.psi = tuple(self.psi[i] for i in idx)
        return out


# ---------------------------------------------------------------------------
# forward / inverse (batched over leading dims and limbs)
# ---------------------------------------------------------------------------

def ntt_forward(a: torch.Tensor, root_powers: torch.Tensor,
                q: torch.Tensor) -> torch.Tensor:
    """Cooley-Tukey DIT, natural -> bitrev. a: (..., L, N)."""
    n = a.shape[-1]
    lead = a.shape[:-1]
    qq = q[..., None, None]
    m = 1
    while m < n:
        t = n // (2 * m)
        a = a.reshape(*lead, m, 2 * t)
        w = root_powers[..., m:2 * m]
        u = a[..., :t]
        v = ma.mulmod(a[..., t:], w[..., :, None], qq)
        a = torch.cat([ma.addmod(u, v, qq), ma.submod(u, v, qq)], dim=-1)
        m *= 2
    return a.reshape(*lead, n)


def ntt_inverse(a: torch.Tensor, inv_root_powers: torch.Tensor,
                q: torch.Tensor, n_inv: torch.Tensor) -> torch.Tensor:
    """Gentleman-Sande DIF, bitrev -> natural (exact inverse of forward)."""
    n = a.shape[-1]
    lead = a.shape[:-1]
    qq = q[..., None, None]
    m = n // 2
    while m >= 1:
        t = n // (2 * m)
        a = a.reshape(*lead, m, 2 * t)
        w = inv_root_powers[..., m:2 * m]
        u = a[..., :t]
        v = a[..., t:]
        s = ma.addmod(u, v, qq)
        d = ma.mulmod(ma.submod(u, v, qq), w[..., :, None], qq)
        a = torch.cat([s, d], dim=-1)
        m //= 2
    a = a.reshape(*lead, n)
    return ma.mulmod(a, n_inv[..., None], q[..., None])


def ntt(a: torch.Tensor, tables: NttTables) -> torch.Tensor:
    return ntt_forward(a, tables.root_powers, tables.q)


def intt(a: torch.Tensor, tables: NttTables) -> torch.Tensor:
    return ntt_inverse(a, tables.inv_root_powers, tables.q, tables.n_inv)


# ---------------------------------------------------------------------------
# Galois automorphisms
# ---------------------------------------------------------------------------

def galois_element(step: int, n: int) -> int:
    """Galois element for Rotate(step) on N/2 slots: 5^step mod 2N."""
    return pow(5, step % (n // 2), 2 * n)


def coeff_perm(galois_elt: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Coefficient-domain automorphism in gather form (src index, negate)."""
    i = np.arange(n, dtype=np.int64)
    e = (i * galois_elt) % (2 * n)
    dest = e % n
    src = np.empty(n, dtype=np.int64)
    neg = np.empty(n, dtype=bool)
    src[dest] = i
    neg[dest] = e >= n
    return src, neg


@functools.lru_cache(maxsize=None)
def _exponent_order_cached(p: int, psi: int, log_n: int) -> tuple:
    """The exponent e_i such that forward-NTT output slot i holds a(psi^{e_i})."""
    n = 1 << log_n
    x_poly = torch.zeros((1, n), dtype=torch.int64)
    x_poly[0, 1] = 1
    rp = torch.from_numpy(
        power_table(psi, p, n)[bit_reverse_vector(n)].astype(np.int64))
    q = torch.tensor([p], dtype=torch.int64)
    vals = ntt_forward(x_poly, rp[None, :], q)[0].tolist()
    odd = range(1, 2 * n, 2)
    val_to_exp = dict(zip(power_table(psi, p, 2 * n)[1::2].tolist(), odd))
    return tuple(val_to_exp[v] for v in vals)


def eval_perm(galois_elt: int, p: int, psi: int, log_n: int) -> np.ndarray:
    """Evaluation(NTT)-domain automorphism permutation:
    out_slot[i] = in_slot[perm[i]] implements sigma_k."""
    n = 1 << log_n
    exps = np.array(_exponent_order_cached(p, psi, log_n), dtype=np.int64)
    pos = np.empty(2 * n, dtype=np.int64)
    pos[exps] = np.arange(n, dtype=np.int64)
    return pos[(exps * galois_elt) % (2 * n)]
