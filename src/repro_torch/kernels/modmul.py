"""K4: elementwise modular product, the CUDA kernel and its plain version.

Replaces `repro/kernels/modmul.py::_modmul_kernel` (``modmul.py:37``,
launched by ``modmul_pallas``). Source: ``repro_torch/csrc/modmul.cu``.
Bound by bytes (8 + 4 read, 8 written per element for one Montgomery
multiply); see the source for what the design does about it.

Contract: ``b_mont`` is already in Montgomery form (``ops.modmul`` does
that), so the result is ``a * b mod q``. Row ``r`` of ``a`` pairs with
row ``r % Rb`` of ``b_mont`` and its modulus, which lets one ``(L, N)``
plaintext serve every ``(B, 2, L)`` ciphertext row without tiling.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (check, mont_mul32, register_kernel,
                                        u32, use_kernel)

MODMUL = register_kernel("modmul", "src/repro_torch/csrc/modmul.cu",
                         "src/repro/kernels/modmul.py:37")


def modmul_mont_plain(a: torch.Tensor, b_mont: torch.Tensor,
                      q32: torch.Tensor, qi32: torch.Tensor) -> torch.Tensor:
    """Plain version of K4 (same arguments and result)."""
    r, n = a.shape
    rb = b_mont.shape[0]
    out = mont_mul32(a.reshape(r // rb, rb, n), u32(b_mont),
                     u32(q32)[:, None], u32(qi32)[:, None])
    return out.reshape(r, n)


def modmul_mont(a: torch.Tensor, b_mont: torch.Tensor, q32: torch.Tensor,
                qi32: torch.Tensor) -> torch.Tensor:
    """a (R, N) int64 residues, b_mont (Rb, N) int32 Montgomery form,
    q32/qi32 (Rb,) int32 with R % Rb == 0 -> (R, N) int64 a*b mod q."""
    r, n = a.shape
    rb = b_mont.shape[0]
    if rb == 0 or r % rb:
        raise ValueError(f"modmul: {r} rows do not tile by {rb}")
    check(a, "a", torch.int64, (r, n))
    check(b_mont, "b_mont", torch.int32, (rb, n))
    check(q32, "q32", torch.int32, (rb,))
    check(qi32, "qi32", torch.int32, (rb,))
    if not use_kernel(a, b_mont, q32, qi32):
        return modmul_mont_plain(a, b_mont, q32, qi32)
    if r > 65535:
        raise ValueError(f"modmul: {r} rows exceed the launch grid")
    out = torch.empty_like(a)
    fn = build.bind(build.library("modmul.cu"), "rt_modmul", 5, 3)
    build.launch(fn, a.data_ptr(), b_mont.data_ptr(), q32.data_ptr(),
                 qi32.data_ptr(), out.data_ptr(), r, rb, n)
    MODMUL.launches += 1
    return out
