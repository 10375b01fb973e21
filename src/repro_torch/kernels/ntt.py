"""K7: the four-step negacyclic NTT, the CUDA kernels and their plain
version.

Replaces `repro/kernels/ntt.py::_ntt_col_kernel` (``ntt.py:52``) and
``_ntt_row_kernel`` (``ntt.py:59``), launched by ``ntt_four_step_pallas``.
Source: ``repro_torch/csrc/ntt.cu``; two kernels, ``ntt_col`` (phase 1:
column NTTs on an (R, block_c) tile) and ``ntt_row`` (phases 2 and 3: the
fused correction multiply and the row NTTs on a (block_r, C) tile), each
with its own launch count. The output is in kernel order
(`ref.FourStepTables`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (addmod32, as_i32, check, mont_mul32,
                                        qinv_neg32, register_kernel,
                                        submod32, u32, use_kernel)
from repro_torch.kernels.ref import FourStepTables

SRC = "src/repro_torch/csrc/ntt.cu"
NTT_COL = register_kernel("ntt_col", SRC, "src/repro/kernels/ntt.py:52")
NTT_ROW = register_kernel("ntt_row", SRC, "src/repro/kernels/ntt.py:59")

SMEM_BYTES = 232448          # shared memory a block may use on Hopper
I32 = torch.int32


class FourStepKernelTables:
    """Montgomery-form tables of one `FourStepTables`, int32 on `device`."""

    def __init__(self, tabs: FourStepTables, device):
        self.tabs = tabs
        q = tabs.q
        r_mont = (1 << 32) % q

        def to_mont(arr):        # arr, r_mont < 2^32: uint64 is exact
            return as_i32(arr.astype(np.uint64) * np.uint64(r_mont)
                          % np.uint64(q), device)

        self.q32 = as_i32([q], device)
        self.qinv32 = as_i32([qinv_neg32(q)], device)
        self.rp_col_m = to_mont(tabs.rp_col)
        self.rp_row_m = to_mont(tabs.rp_row)
        self.t2_m = to_mont(tabs.t2_fused)


def _ct_stages_axis0(x, rp, q, qi):
    """Harvey CT butterflies along axis 0 of x (R, B); rp (R,) Montgomery."""
    r, b = x.shape
    m = 1
    while m < r:
        t = r // (2 * m)
        xr = x.reshape(m, 2 * t, b)
        u = xr[:, :t]
        v = mont_mul32(xr[:, t:], rp[m:2 * m, None, None], q, qi)
        x = torch.cat([addmod32(u, v, q), submod32(u, v, q)],
                      dim=1).reshape(r, b)
        m *= 2
    return x


def ntt_col_plain(a, kt: FourStepKernelTables):
    """Plain version of `ntt_col` (same arguments and result)."""
    tabs = kt.tabs
    q, qi = u32(kt.q32), u32(kt.qinv32)
    return _ct_stages_axis0(a.reshape(tabs.r, tabs.c), u32(kt.rp_col_m), q,
                            qi).to(I32)


def ntt_row_plain(y, kt: FourStepKernelTables):
    """Plain version of `ntt_row` (same arguments and result)."""
    q, qi = u32(kt.q32), u32(kt.qinv32)
    x = mont_mul32(u32(y), u32(kt.t2_m), q, qi)
    return _ct_stages_axis0(x.T, u32(kt.rp_row_m), q, qi).T.reshape(-1)


def ntt_four_step_plain(a, kt: FourStepKernelTables):
    """Plain version of `ntt_four_step` (the tiles do not change what is
    computed)."""
    return ntt_row_plain(ntt_col_plain(a, kt), kt)


def _block(kt: FourStepKernelTables, block: int, dim: int) -> int:
    """A tile edge clamped to its dimension; it must divide it (the
    reference's `dim // block` grid would drop the tail tile)."""
    block = min(block, dim)
    if block < 1 or dim % block:
        raise ValueError(
            f"four-step NTT blocks must divide the (R, C)=({kt.tabs.r}, "
            f"{kt.tabs.c}) tile grid; got {block} for {dim}")
    return block


def _fits(tile: int) -> None:
    if 4 * tile > SMEM_BYTES:
        raise ValueError(f"four-step NTT tile of {tile} words exceeds a "
                         f"block's shared memory")


def ntt_col(a: torch.Tensor, kt: FourStepKernelTables,
            block_c: int) -> torch.Tensor:
    """Phase 1: a (N,) int64 viewed as (R, C) -> (R, C) int32, each column
    through its R-point NTT; one block per (R, block_c) tile."""
    r, c = kt.tabs.r, kt.tabs.c
    block_c = _block(kt, block_c, c)
    check(a, "a", torch.int64, (r * c,))
    if not use_kernel(a, kt.t2_m):
        return ntt_col_plain(a, kt)
    _fits(r * block_c)
    y = torch.empty((r, c), dtype=I32, device=a.device)
    fn = build.bind(build.library("ntt.cu"), "rt_ntt_col", 5, 3)
    build.launch(fn, a.data_ptr(), y.data_ptr(), kt.rp_col_m.data_ptr(),
                 kt.q32.data_ptr(), kt.qinv32.data_ptr(), r.bit_length() - 1,
                 c, block_c)
    NTT_COL.launches += 1
    return y


def ntt_row(y: torch.Tensor, kt: FourStepKernelTables,
            block_r: int) -> torch.Tensor:
    """Phases 2 and 3: y (R, C) int32 times t2, each row through its
    C-point NTT -> (N,) int64; one block per (block_r, C) tile."""
    r, c = kt.tabs.r, kt.tabs.c
    block_r = _block(kt, block_r, r)
    check(y, "y", I32, (r, c))
    if not use_kernel(y, kt.t2_m):
        return ntt_row_plain(y, kt)
    _fits(block_r * c)
    out = torch.empty(r * c, dtype=torch.int64, device=y.device)
    fn = build.bind(build.library("ntt.cu"), "rt_ntt_row", 6, 3)
    build.launch(fn, y.data_ptr(), kt.t2_m.data_ptr(), kt.rp_row_m.data_ptr(),
                 kt.q32.data_ptr(), kt.qinv32.data_ptr(), out.data_ptr(), r,
                 c.bit_length() - 1, block_r)
    NTT_ROW.launches += 1
    return out


def ntt_four_step(a: torch.Tensor, kt: FourStepKernelTables, *,
                  block_c: int = 128, block_r: int = 8) -> torch.Tensor:
    """a: (N,) int64 coefficients < q -> (N,) int64 in kernel order. The
    blocks are clamped to R and C and must divide them (ValueError)."""
    _block(kt, block_r, kt.tabs.r)
    return ntt_row(ntt_col(a, kt, block_c), kt, block_r)
