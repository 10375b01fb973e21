"""CkksContext: the precompute hub for a CKKS parameter set.

Owns the moduli chain, NTT tables for the full Q∪P basis, reduction
constants, and cached BConv tables and Galois permutations, all as
tensors on the context's device. Everything is host-precomputed once.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import modarith as ma
from repro_torch.core import ntt as nttm
from repro_torch.core import rns
from repro_torch.core.params import CkksParams

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Asking for CUDA (explicitly or by default) where there is
    none raises; it never carries on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' (or --device cpu) to run on the "
            "CPU")
    return dev


class CkksContext:

    def __init__(self, params: CkksParams, device: DeviceLike = None):
        self.params = params
        self.device = resolve_device(device)
        self.log_n = params.log_n
        self.n = params.n
        self.moduli = params.moduli                       # Q then P
        self.n_q = params.n_q_moduli
        self.n_p = params.n_special
        self.primes: List[int] = [m.value for m in self.moduli]
        self.q_primes = self.primes[: self.n_q]
        self.p_primes = self.primes[self.n_q:]

        # NTT tables over the whole basis; limb slices are cheap views.
        self.tables = nttm.NttTables(self.moduli, self.log_n, self.device)
        self.q_all = self.tables.q                        # (n_q+n_p,)

        self.barrett_mu = self._t([ma.barrett_mu(p) for p in self.primes])
        self.mont_qinv_neg = self._t([ma.mont_qinv_neg(p)
                                      for p in self.primes])
        self.mont_r2 = self._t([ma.mont_r2(p) for p in self.primes])

        # P^{-1} mod q_j (ModDown constant)
        big_p = 1
        for p in self.p_primes:
            big_p *= p
        self.big_p = big_p
        self.p_inv_mod_q = self._t([pow(big_p % q, -1, q)
                                    for q in self.q_primes])

        # constants[l][i] = q_l^{-1} mod q_i for i < l (rescale from l)
        self._qlast_inv: List[torch.Tensor] = [self._t([])]
        for l in range(1, self.n_q):
            ql = self.q_primes[l]
            self._qlast_inv.append(self._t(
                [pow(ql % qi, -1, qi) for qi in self.q_primes[:l]]))

        self._bconv_cache: Dict[Tuple[Tuple[int, ...], Tuple[int, ...]],
                                rns.BConvTables] = {}
        self._eval_perm_cache: Dict[int, torch.Tensor] = {}
        self._limb_tables_cache: Dict[Tuple[int, ...], nttm.NttTables] = {}

    def _t(self, values) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.int64, device=self.device)

    def index(self, idx: Sequence[int]) -> torch.Tensor:
        """Limb indices as an index tensor on this context's device."""
        return torch.tensor(list(idx), dtype=torch.int64, device=self.device)

    # -- basis helpers ------------------------------------------------------

    def q_idx(self, level: int) -> List[int]:
        """Global limb indices of the active Q basis at `level`."""
        return list(range(level + 1))

    def p_idx(self) -> List[int]:
        return list(range(self.n_q, self.n_q + self.n_p))

    def limb_tables(self, idx: Sequence[int]) -> nttm.NttTables:
        key = tuple(idx)
        if key not in self._limb_tables_cache:
            self._limb_tables_cache[key] = self.tables.slice_limbs(list(key))
        return self._limb_tables_cache[key]

    def bconv_tables(self, src_idx: Sequence[int],
                     dst_idx: Sequence[int]) -> rns.BConvTables:
        key = (tuple(src_idx), tuple(dst_idx))
        if key not in self._bconv_cache:
            self._bconv_cache[key] = rns.make_bconv_tables(
                [self.primes[i] for i in key[0]],
                [self.primes[i] for i in key[1]], self.device)
        return self._bconv_cache[key]

    # -- NTT wrappers over global limb indices ------------------------------

    def ntt(self, a: torch.Tensor, idx: Sequence[int]) -> torch.Tensor:
        return nttm.ntt(a, self.limb_tables(idx))

    def intt(self, a: torch.Tensor, idx: Sequence[int]) -> torch.Tensor:
        return nttm.intt(a, self.limb_tables(idx))

    # -- Galois -------------------------------------------------------------

    def eval_perm(self, galois_elt: int) -> torch.Tensor:
        """NTT-domain automorphism permutation (same for every limb)."""
        if galois_elt not in self._eval_perm_cache:
            perm = nttm.eval_perm(galois_elt, self.primes[0],
                                  self.tables.psi[0], self.log_n)
            self._eval_perm_cache[galois_elt] = torch.from_numpy(
                perm).to(self.device)
        return self._eval_perm_cache[galois_elt]

    def rotation_element(self, step: int) -> int:
        return nttm.galois_element(step, self.n)

    @property
    def conj_element(self) -> int:
        return 2 * self.n - 1

    # -- misc ---------------------------------------------------------------

    def qlast_inv(self, level: int) -> torch.Tensor:
        return self._qlast_inv[level]

    @functools.cached_property
    def q_products(self) -> List[int]:
        """prod(q_0..q_l) per level (python ints, for scale bookkeeping)."""
        out, acc = [], 1
        for p in self.q_primes:
            acc *= p
            out.append(acc)
        return out


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host residues (any integer dtype, values < 2^63) -> int64 tensor."""
    return torch.from_numpy(np.ascontiguousarray(x).astype(np.int64)).to(
        device)
