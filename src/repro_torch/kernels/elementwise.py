"""The engine's modular elementwise passes: the HMul tensor product, the
keyswitch combine and HAdd/HSub, each one CUDA launch beside its plain
version.

They replace what the reference jits as one XLA fusion each: the tensor
product (``repro/compiler/engine.py:348``, ``build_tensor`` of
``_hmul_fused``), the combine (``:366``, ``build_combine``; the rotation's
at ``:477``) and ``_addsub`` (``:313``). Source:
``repro_torch/csrc/elementwise.cu``; see it for the design. All three are
bound by bytes.

Operands are int64 residues below their limb's prime and may be views:
``(B, 2, l, N)`` or ``(B, l, N)`` with any batch and component strides,
limbs N apart and coefficients contiguous (the engine's limb slices, the
rotated ciphertext's b component). Results are fresh and contiguous, and
bit-identical to ``core/ops.tensor``, ``core/modarith.addmod`` and
``submod``.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (addmod32, as_i32, mont_mul32,
                                        qinv_neg32, register_kernel,
                                        submod32, u32, use_kernel)

SRC = "src/repro_torch/csrc/elementwise.cu"
TENSOR = register_kernel("tensor", SRC, "src/repro/compiler/engine.py:348")
COMBINE = register_kernel("combine", SRC, "src/repro/compiler/engine.py:366")
ADDSUB = register_kernel("addsub", SRC, "src/repro/compiler/engine.py:313")

I64 = torch.int64
MAX_ROWS = 65535        # the launch grid's y extent: one row a block row
MAX_STRIDE = 2 ** 31 - 1


class Basis(NamedTuple):
    """Per-limb constants of the passes, each (l,) int32 u32 bits."""
    q32: torch.Tensor       # the primes
    qi32: torch.Tensor      # -q^-1 mod 2^32
    r2: torch.Tensor        # R^2 mod q, R = 2^32


@lru_cache(maxsize=256)
def _basis(primes: Tuple[int, ...], device: str) -> Basis:
    return Basis(as_i32(primes, device),
                 as_i32([qinv_neg32(p) for p in primes], device),
                 as_i32([(1 << 64) % p for p in primes], device))


def basis(primes: Sequence[int], device) -> Basis:
    """The constants of a limb basis on `device`, built once a pair."""
    return _basis(tuple(int(p) for p in primes), str(device))


def _strides(t: torch.Tensor, name: str, shape) -> Tuple[int, ...]:
    """Check one int64 operand of `shape` whose last two dims are a
    (limb, coefficient) block laid out as rows of N; return its leading
    strides in elements."""
    if t.dtype != I64:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {I64}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    n = shape[-1]
    if t.stride(-1) != 1 or (shape[-2] > 1 and t.stride(-2) != n):
        raise ValueError(f"{name}: limbs and coefficients not contiguous "
                         f"rows of {n} (strides {t.stride()})")
    lead = tuple(t.stride(d) for d in range(t.dim() - 2))
    if any(s < 0 or s > MAX_STRIDE for s in lead):
        raise ValueError(f"{name}: strides {t.stride()} outside the "
                         f"kernel's int32 range")
    return lead


def _check_q(q: torch.Tensor, name: str, l: int) -> None:
    if q.dtype != torch.int32:
        raise TypeError(f"{name}: dtype {q.dtype}, expected torch.int32")
    if tuple(q.shape) != (l,) or not q.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous ({l},) tensor, "
                         f"got {tuple(q.shape)}")


@lru_cache(maxsize=None)
def _entry(name: str, n_ptr: int, n_int: int):
    """A C entry of the library, bound once: these passes sit on the
    engine's hot path, where the card waits for their first launch."""
    return build.bind(build.library("elementwise.cu"), name, n_ptr, n_int)


def _check_rows(name: str, rows: int) -> None:
    if rows > MAX_ROWS:
        raise ValueError(f"{name}: {rows} rows exceed the launch grid")


# ---------------------------------------------------------------------------
# the tensor product
# ---------------------------------------------------------------------------

def tensor_plain(d0: torch.Tensor, d1: torch.Tensor, bs: Basis
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the tensor kernel (same arguments and result),
    in its arithmetic: two Montgomery products for each exact one."""
    q, qi, r2 = (u32(t)[:, None] for t in bs)
    b0, a0, b1, a1 = d0[:, 0], d0[:, 1], d1[:, 0], d1[:, 1]

    def mont(x, y):
        return mont_mul32(x, y, q, qi)
    mid = addmod32(mont(a0, b1), mont(a1, b0), q)
    return (mont(mont(b0, b1), r2), mont(mid, r2),
            mont(mont(a0, a1), r2))


def tensor(d0: torch.Tensor, d1: torch.Tensor, bs: Basis
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Tensor product of two (B, 2, l, N) int64 ciphertexts over the l
    limbs of `bs`: (t0, t1, d2) = (b0 b1, a0 b1 + a1 b0, a0 a1) mod q,
    each (B, l, N) contiguous, equal to core/ops.tensor."""
    b, _, l, n = d0.shape
    shape = (b, 2, l, n)
    sb0, sc0 = _strides(d0, "d0", shape)
    sb1, sc1 = _strides(d1, "d1", shape)
    for name, t in zip(Basis._fields, bs):
        _check_q(t, name, l)
    if not use_kernel(d0, d1, *bs):
        return tensor_plain(d0, d1, bs)
    _check_rows("tensor", b * l)
    t0, t1, d2 = torch.empty((3, b, l, n), dtype=I64,
                             device=d0.device).unbind(0)
    fn = _entry("rt_tensor", 8, 7)
    build.launch(fn, d0.data_ptr(), d1.data_ptr(), *(t.data_ptr()
                                                      for t in bs),
                 t0.data_ptr(), t1.data_ptr(), d2.data_ptr(), b, l, n, sb0,
                 sc0, sb1, sc1)
    TENSOR.launches += 1
    return t0, t1, d2


# ---------------------------------------------------------------------------
# the keyswitch combine
# ---------------------------------------------------------------------------

def combine_plain(x0: torch.Tensor, x1: Optional[torch.Tensor],
                  e0: torch.Tensor, e1: torch.Tensor, q32: torch.Tensor
                  ) -> torch.Tensor:
    """Plain version of the combine kernel (same arguments and result)."""
    q = u32(q32)[:, None]
    second = e1 if x1 is None else addmod32(x1, e1, q)
    return torch.stack([addmod32(x0, e0, q), second], dim=1)


def combine(x0: torch.Tensor, x1: Optional[torch.Tensor], e0: torch.Tensor,
            e1: torch.Tensor, q32: torch.Tensor) -> torch.Tensor:
    """A keyswitch's (e0, e1) added back: (B, 2, l, N) int64 holding
    [x0 + e0, x1 + e1] mod q, or [x0 + e0, e1] where x1 is None (a
    rotation). Every operand (B, l, N) int64; q32 (l,) int32."""
    b, l, n = x0.shape
    shape = (b, l, n)
    ops = {"x0": x0, "x1": x1, "e0": e0, "e1": e1}
    strides = {k: (_strides(t, k, shape)[0] if t is not None else 0)
               for k, t in ops.items()}
    _check_q(q32, "q32", l)
    given = [t for t in ops.values() if t is not None]
    if not use_kernel(*given, q32):
        return combine_plain(x0, x1, e0, e1, q32)
    _check_rows("combine", b * l)
    out = torch.empty((b, 2, l, n), dtype=I64, device=x0.device)
    fn = _entry("rt_combine", 6, 7)
    build.launch(fn, x0.data_ptr(), x1.data_ptr() if x1 is not None else
                 None, e0.data_ptr(), e1.data_ptr(), q32.data_ptr(),
                 out.data_ptr(), b, l, n, *strides.values())
    COMBINE.launches += 1
    return out


# ---------------------------------------------------------------------------
# HAdd / HSub
# ---------------------------------------------------------------------------

def addsub_plain(a: torch.Tensor, b: torch.Tensor, q32: torch.Tensor,
                 sub: bool) -> torch.Tensor:
    """Plain version of the addsub kernel (same arguments and result)."""
    return (submod32 if sub else addmod32)(a, b, u32(q32)[:, None])


def addsub(a: torch.Tensor, b: torch.Tensor, q32: torch.Tensor,
           sub: bool) -> torch.Tensor:
    """(a - b) mod q if `sub`, else (a + b) mod q, of two (B, 2, l, N)
    int64 ciphertexts; q32 (l,) int32. Returns (B, 2, l, N) contiguous."""
    bt, _, l, n = a.shape
    shape = (bt, 2, l, n)
    sba, sca = _strides(a, "a", shape)
    sbb, scb = _strides(b, "b", shape)
    _check_q(q32, "q32", l)
    if not use_kernel(a, b, q32):
        return addsub_plain(a, b, q32, sub)
    _check_rows("addsub", bt * 2 * l)
    out = torch.empty(shape, dtype=I64, device=a.device)
    fn = _entry("rt_addsub", 4, 8)
    build.launch(fn, a.data_ptr(), b.data_ptr(), q32.data_ptr(),
                 out.data_ptr(), bt, l, n, sba, sca, sbb, scb, int(sub))
    ADDSUB.launches += 1
    return out
