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
from repro_torch.kernels.common import as_i32, qinv_neg32, to_mont_int


class BConvTables(NamedTuple):
    """Host-precomputed constants for one (src basis -> dst basis) pair,
    and K6's operands (u32 bit patterns in int32), built with them once."""
    qhat_inv: torch.Tensor   # (S,)  [qhat_j^{-1}]_{q_j}
    w: torch.Tensor          # (S, D) [qhat_j]_{p_i}
    src_q: torch.Tensor      # (S,)
    dst_q: torch.Tensor      # (D,)
    w_mont: torch.Tensor     # (D, S) [qhat_j]_{p_i} * 2^32 mod p_i
    dst_q32: torch.Tensor    # (D,)  p_i
    dst_qinv32: torch.Tensor  # (D,) -p_i^{-1} mod 2^32


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

    w_mont = [[to_mont_int(w[j][i], p) for j in range(len(src))]
              for i, p in enumerate(dst)]
    return BConvTables(qhat_inv=t(qhat_inv), w=t(w).reshape(len(src),
                                                            len(dst)),
                       src_q=t(src), dst_q=t(dst),
                       w_mont=as_i32(w_mont, device),
                       dst_q32=as_i32(dst, device),
                       dst_qinv32=as_i32([qinv_neg32(p) for p in dst],
                                         device))


def bconv(a: torch.Tensor, t: BConvTables) -> torch.Tensor:
    """Fast base conversion. a: (..., S, N) coeff domain -> (..., D, N)."""
    v = ma.mulmod(a, t.qhat_inv[:, None], t.src_q[:, None])
    acc = None
    for j in range(v.shape[-2]):
        term = ma.mulmod(v[..., j:j + 1, :], t.w[j][:, None],
                         t.dst_q[:, None])
        acc = term if acc is None else acc + term   # sum < S * 2^31
    return acc % t.dst_q[:, None]


def bconv_matmul(a: torch.Tensor, t: BConvTables) -> torch.Tensor:
    """BConv as an explicit (S, N) x (S, D) contraction with lazy
    accumulation, the reference's form for the kernel and MXU mapping:
    products are summed unreduced and folded mod p every 4 of them. The
    reference's u64 sum assumes v < 2^31 and w < 2^30 and wraps at the
    32-bit special prime; here each product is split into 32-bit words
    (`modarith.mul_wide`) and the sum carries its low word into its high
    word, so the result equals `bconv` at every prime below 2^32."""
    v = ma.mulmod(a, t.qhat_inv[:, None], t.src_q[:, None])
    q = t.dst_q[:, None]
    r32 = ((1 << 32) % t.dst_q)[:, None]
    s = v.shape[-2]
    acc = torch.zeros(a.shape[:-2] + (t.w.shape[1],) + a.shape[-1:],
                      dtype=torch.int64, device=a.device)
    run_hi = run_lo = None
    for j in range(s):
        hi, lo = ma.mul_wide(v[..., j:j + 1, :], t.w[j][:, None])
        if run_hi is None:
            run_hi, run_lo = hi, lo
        else:
            lo = run_lo + lo                                   # < 2^33
            run_hi, run_lo = run_hi + hi + (lo >> 32), lo & ma.MASK32
        if (j + 1) % 4 == 0 or j == s - 1:                     # fold every 4
            run = ma.addmod(ma.mulmod(run_hi % q, r32, q), run_lo % q, q)
            acc = ma.addmod(acc, run, q)
            run_hi = run_lo = None
    return acc


def mod_down_coeff(a_q: torch.Tensor, a_p_converted: torch.Tensor,
                   p_inv_mod_q: torch.Tensor,
                   q: torch.Tensor) -> torch.Tensor:
    """(a_q - BConv_{P->Q}(a_p)) * P^{-1} mod q. All (..., L, N)."""
    diff = ma.submod(a_q, a_p_converted % q[:, None], q[:, None])
    return ma.mulmod(diff, p_inv_mod_q[:, None], q[:, None])


def exact_div_by_last_coeff(a: torch.Tensor, q_last_inv: torch.Tensor,
                            q: torch.Tensor) -> torch.Tensor:
    """Rescale core: given a (..., L, N) with the last limb already
    broadcast-subtracted, multiply by q_last^{-1} mod q_i."""
    return ma.mulmod(a, q_last_inv[:, None], q[:, None])


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
