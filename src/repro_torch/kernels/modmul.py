"""K4 (elementwise modular product) and K5 (modular multiply-accumulate):
the CUDA kernels and their plain versions.

K4 replaces `repro/kernels/modmul.py::_modmul_kernel` (``modmul.py:37``,
launched by ``modmul_pallas``); K5 replaces ``_mulacc_kernel``
(``modmul.py:43``, launched by ``mulacc_pallas``). Source:
``repro_torch/csrc/modmul.cu``. Both are bound by bytes (K4: 8 + 4 read,
8 written per element; K5: 8 + 4 + 8 read, 8 written); see the source for
what the design does about it.

Contract: ``b_mont`` is already in Montgomery form (``ops.modmul`` and
``ops.mulacc`` do that), so the result is ``a * b mod q`` (K5: plus ``c``,
which is reduced). Row ``r`` of ``a`` pairs with row ``r % Rb`` of
``b_mont`` and its modulus, which lets one ``(L, N)`` plaintext serve
every ``(B, 2, L)`` ciphertext row without tiling.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (addmod32, check, mont_mul32,
                                        register_kernel, u32, use_kernel)

SRC = "src/repro_torch/csrc/modmul.cu"
MODMUL = register_kernel("modmul", SRC, "src/repro/kernels/modmul.py:37")
MULACC = register_kernel("mulacc", SRC, "src/repro/kernels/modmul.py:43")


def modmul_mont_plain(a: torch.Tensor, b_mont: torch.Tensor,
                      q32: torch.Tensor, qi32: torch.Tensor) -> torch.Tensor:
    """Plain version of K4 (same arguments and result)."""
    r, n = a.shape
    rb = b_mont.shape[0]
    out = mont_mul32(a.reshape(r // rb, rb, n), u32(b_mont),
                     u32(q32)[:, None], u32(qi32)[:, None])
    return out.reshape(r, n)


def _check_rows(name, a, b_mont, q32, qi32):
    """Operand checks shared by K4 and K5; returns (R, Rb, N)."""
    r, n = a.shape
    rb = b_mont.shape[0]
    if rb == 0 or r % rb:
        raise ValueError(f"{name}: {r} rows do not tile by {rb}")
    check(a, "a", torch.int64, (r, n))
    check(b_mont, "b_mont", torch.int32, (rb, n))
    check(q32, "q32", torch.int32, (rb,))
    check(qi32, "qi32", torch.int32, (rb,))
    return r, rb, n


def _check_grid(name, r):
    if r > 65535:
        raise ValueError(f"{name}: {r} rows exceed the launch grid")


def modmul_mont(a: torch.Tensor, b_mont: torch.Tensor, q32: torch.Tensor,
                qi32: torch.Tensor) -> torch.Tensor:
    """a (R, N) int64 residues, b_mont (Rb, N) int32 Montgomery form,
    q32/qi32 (Rb,) int32 with R % Rb == 0 -> (R, N) int64 a*b mod q."""
    r, rb, n = _check_rows("modmul", a, b_mont, q32, qi32)
    if not use_kernel(a, b_mont, q32, qi32):
        return modmul_mont_plain(a, b_mont, q32, qi32)
    _check_grid("modmul", r)
    out = torch.empty_like(a)
    fn = build.bind(build.library("modmul.cu"), "rt_modmul", 5, 3)
    build.launch(fn, a.data_ptr(), b_mont.data_ptr(), q32.data_ptr(),
                 qi32.data_ptr(), out.data_ptr(), r, rb, n)
    MODMUL.launches += 1
    return out


def mulacc_mont_plain(a: torch.Tensor, b_mont: torch.Tensor, c: torch.Tensor,
                      q32: torch.Tensor, qi32: torch.Tensor) -> torch.Tensor:
    """Plain version of K5 (same arguments and result)."""
    r, n = a.shape
    rb = b_mont.shape[0]
    q = u32(q32)[:, None]
    prod = mont_mul32(a.reshape(r // rb, rb, n), u32(b_mont), q,
                      u32(qi32)[:, None])
    return addmod32(prod, c.reshape(r // rb, rb, n), q).reshape(r, n)


def mulacc_mont(a: torch.Tensor, b_mont: torch.Tensor, c: torch.Tensor,
                q32: torch.Tensor, qi32: torch.Tensor) -> torch.Tensor:
    """a, c (R, N) int64 residues, b_mont (Rb, N) int32 Montgomery form,
    q32/qi32 (Rb,) int32 with R % Rb == 0 -> (R, N) int64 (a*b + c) mod q."""
    r, rb, n = _check_rows("mulacc", a, b_mont, q32, qi32)
    check(c, "c", torch.int64, (r, n))
    if not use_kernel(a, b_mont, c, q32, qi32):
        return mulacc_mont_plain(a, b_mont, c, q32, qi32)
    _check_grid("mulacc", r)
    out = torch.empty_like(a)
    fn = build.bind(build.library("modmul.cu"), "rt_mulacc", 6, 3)
    build.launch(fn, a.data_ptr(), b_mont.data_ptr(), c.data_ptr(),
                 q32.data_ptr(), qi32.data_ptr(), out.data_ptr(), r, rb, n)
    MULACC.launches += 1
    return out
