"""RNS basis tooling on torch tensors: fast base conversion (BConv),
ModDown core, and the exact CRT lift used by decode.

BConv_{Q->P}(a)_i = [ sum_j [a_j * qhat_j^{-1}]_{q_j} * [qhat_j]_{p_i} ]_{p_i}
on coefficient-domain limbs (an iNTT precedes it), exactly the reference's
schedule: every partial product is reduced before it is summed.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import modarith as ma


class BConvTables(NamedTuple):
    """Host-precomputed constants for one (src basis -> dst basis) pair."""
    qhat_inv: torch.Tensor   # (S,)  [qhat_j^{-1}]_{q_j}
    w: torch.Tensor          # (S, D) [qhat_j]_{p_i}
    src_q: torch.Tensor      # (S,)
    dst_q: torch.Tensor      # (D,)


def make_bconv_tables(src_primes: Sequence[int], dst_primes: Sequence[int],
                      device: torch.device) -> BConvTables:
    src = [int(p) for p in src_primes]
    dst = [int(p) for p in dst_primes]
    big_q = 1
    for p in src:
        big_q *= p
    qhat = [big_q // p for p in src]
    qhat_inv = [pow(h % p, -1, p) for h, p in zip(qhat, src)]
    w = [[h % pi for pi in dst] for h in qhat]

    def t(x):
        return torch.tensor(x, dtype=torch.int64, device=device)
    return BConvTables(qhat_inv=t(qhat_inv), w=t(w).reshape(len(src),
                                                            len(dst)),
                       src_q=t(src), dst_q=t(dst))


def bconv(a: torch.Tensor, t: BConvTables) -> torch.Tensor:
    """Fast base conversion. a: (..., S, N) coeff domain -> (..., D, N)."""
    v = ma.mulmod(a, t.qhat_inv[:, None], t.src_q[:, None])
    acc = None
    for j in range(v.shape[-2]):
        term = ma.mulmod(v[..., j:j + 1, :], t.w[j][:, None],
                         t.dst_q[:, None])
        acc = term if acc is None else acc + term   # sum < S * 2^31
    return acc % t.dst_q[:, None]


def mod_down_coeff(a_q: torch.Tensor, a_p_converted: torch.Tensor,
                   p_inv_mod_q: torch.Tensor,
                   q: torch.Tensor) -> torch.Tensor:
    """(a_q - BConv_{P->Q}(a_p)) * P^{-1} mod q. All (..., L, N)."""
    diff = ma.submod(a_q, a_p_converted % q[:, None], q[:, None])
    return ma.mulmod(diff, p_inv_mod_q[:, None], q[:, None])


def crt_lift_centered(limbs: np.ndarray, primes: Sequence[int]) -> np.ndarray:
    """Exact CRT reconstruction to centered Python ints (host, object array).

    limbs: (L, N) integers. Returns (N,) object array in (-Q/2, Q/2].
    """
    primes = [int(p) for p in primes]
    big_q = 1
    for p in primes:
        big_q *= p
    acc = np.zeros(limbs.shape[-1], dtype=object)
    for j, p in enumerate(primes):
        qhat = big_q // p
        corr = qhat * pow(qhat % p, -1, p)
        acc = (acc + limbs[j].astype(object) * corr) % big_q
    return np.where(acc > big_q // 2, acc - big_q, acc)
