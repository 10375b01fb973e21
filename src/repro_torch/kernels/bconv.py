"""K6: the BConv accumulation, the CUDA kernel and its plain version.

    out[d, n] = sum_j v[j, n] * w[j, d]  (mod p_d)

Replaces `repro/kernels/bconv.py::_bconv_kernel` (``bconv.py:27``) and
``_bconv_kernel_lazy`` (``bconv.py:39``), launched by ``bconv_pallas``.
Source: ``repro_torch/csrc/bconv.cu``, one template with a ``lazy`` flag,
counted as two kernels (``bconv`` and ``bconv_lazy``). Bound by bytes;
see the source for the design.

Eager reduces and adds every product; lazy adds two reduced products,
folds the pair once and adds it (what the reference code does). Both are
exact, so both return the same values. Sums are formed in 64 bits: p_d
reaches 2^32 in the staged keyswitch (fault F2 of the reference, whose
u32 pair sum wraps there).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (addmod32, check, mont_mul32,
                                        register_kernel, u32, use_kernel)

SRC = "src/repro_torch/csrc/bconv.cu"
BCONV = register_kernel("bconv", SRC, "src/repro/kernels/bconv.py:27")
BCONV_LAZY = register_kernel("bconv_lazy", SRC,
                             "src/repro/kernels/bconv.py:39")

SMEM_BYTES = 232448          # shared memory a block may use on Hopper
THREADS = 256                # csrc/bconv.cu: columns per block


def bconv_plain(v: torch.Tensor, w_mont: torch.Tensor, p32: torch.Tensor,
                pinv32: torch.Tensor, lazy: bool = False) -> torch.Tensor:
    """Plain version of K6 (same arguments and result)."""
    s = v.shape[0]
    p, pi = u32(p32)[:, None], u32(pinv32)[:, None]
    w = u32(w_mont)

    def term(j):
        return mont_mul32(v[j][None, :], w[:, j:j + 1], p, pi)

    acc = torch.zeros((w.shape[0], v.shape[1]), dtype=torch.int64,
                      device=v.device)
    j = 0
    while j < s:
        if lazy and j + 1 < s:
            pair = term(j) + term(j + 1)             # < 2p
            acc = addmod32(acc, torch.where(pair >= p, pair - p, pair), p)
            j += 2
        else:
            acc = addmod32(acc, term(j), p)
            j += 1
    return acc


def bconv_mont(v: torch.Tensor, w_mont: torch.Tensor, p32: torch.Tensor,
               pinv32: torch.Tensor, lazy: bool = False) -> torch.Tensor:
    """v (S, N) int64, each row reduced mod its own source prime (< 2^32);
    w_mont (D, S) int32, [w_j]_{p_d} in Montgomery form w.r.t. p_d;
    p32/pinv32 (D,) int32 -> (D, N) int64."""
    s, n = v.shape
    d = w_mont.shape[0]
    check(v, "v", torch.int64, (s, n))
    check(w_mont, "w_mont", torch.int32, (d, s))
    check(p32, "p32", torch.int32, (d,))
    check(pinv32, "pinv32", torch.int32, (d,))
    if not use_kernel(v, w_mont, p32, pinv32):
        return bconv_plain(v, w_mont, p32, pinv32, lazy)
    if 4 * s * (d + THREADS) > SMEM_BYTES:
        raise ValueError(f"bconv: {s} sources x {d} outputs exceed a "
                         f"block's shared memory")
    out = torch.empty((d, n), dtype=torch.int64, device=v.device)
    fn = build.bind(build.library("bconv.cu"), "rt_bconv", 5, 4)
    build.launch(fn, v.data_ptr(), w_mont.data_ptr(), p32.data_ptr(),
                 pinv32.data_ptr(), out.data_ptr(), s, d, n, int(lazy))
    (BCONV_LAZY if lazy else BCONV).launches += 1
    return out
