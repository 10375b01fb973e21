"""K7: the four-step negacyclic NTT, the CUDA kernels and their plain
version.

Replaces `repro/kernels/ntt.py::_ntt_col_kernel` (``ntt.py:52``) and
``_ntt_row_kernel`` (``ntt.py:59``), launched by ``ntt_four_step_pallas``.
Source: ``repro_torch/csrc/ntt.cu``; two kernels, ``ntt_col`` (phase 1:
the column NTTs, each run by R / 16 threads holding its values in
registers, 8 adjacent columns a block up to R = 2048, fewer above) and
``ntt_row`` (phases 2 and 3: each row's correction multiply, fused into
its load, and its NTT, run by C / 16 threads holding its values in
registers, `row_block` rows a block), each with its own launch count.
The output is in kernel order (`ref.FourStepTables`).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (SCHED_VALS, addmod32, as_i32, check,
                                        mont_mul32, qinv_neg32,
                                        register_kernel, sched_passes,
                                        sched_pos, sched_radix, submod32,
                                        u32, use_kernel)
from repro_torch.kernels.ref import FourStepTables

SRC = "src/repro_torch/csrc/ntt.cu"
NTT_COL = register_kernel("ntt_col", SRC, "src/repro/kernels/ntt.py:52")
NTT_ROW = register_kernel("ntt_row", SRC, "src/repro/kernels/ntt.py:59")

SMEM_BYTES = 232448          # shared memory a block may use on Hopper
COL_BLOCK = 8                # adjacent columns a block of ntt_col takes
MAX_THREADS = 1024           # threads of a block
MAX_COL_LOG_R = 14           # R / 16 threads a column: 1024 at most
MAX_ROW_LOG_C = 14           # C / 16 threads a row: 1024 at most
ROW_THREADS = 16             # threads a block of ntt_row aims at
ROW_MAX_THREADS = 64         # ntt_row's launch bound where a row takes fewer
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


def col_block(log_r: int, c: int) -> int:
    """Columns a block of ntt_col takes (csrc/ntt.cu ``col_block``):
    `COL_BLOCK`, fewer when C is smaller or when R / 16 threads a column
    would pass `MAX_THREADS` (R > 2048)."""
    bc = min(COL_BLOCK, c)
    return min(bc, MAX_THREADS >> (log_r - 4)) if log_r > 4 else bc


def col_word(row, col, bc: int):
    """Word of (row, column) in ntt_col's exchange buffer (csrc/ntt.cu
    ``col_word``): columns innermost, one pad row after every 16 rows."""
    return (row + (row >> 4)) * bc + col


def ntt_col_sched(a, kt: FourStepKernelTables):
    """`ntt_col` computed as its threads compute it, on int64 tensors with
    the kernel's index formulas: a column of R <= 16 values is one
    thread's single radix pass; above that, thread tid of a column holds
    the 16 values `common.sched_pos` gives it in each radix pass of the
    column's R points, and the passes exchange values through each block's
    buffer of `col_block` columns laid out by `col_word`."""
    tabs = kt.tabs
    r, c = tabs.r, tabs.c
    log_r = r.bit_length() - 1
    q, qi = u32(kt.q32), u32(kt.qinv32)
    rp = u32(kt.rp_col_m)[None, :]
    x = u32(a.reshape(r, c).T)           # (C, R): one column a row
    if log_r < 5:
        y = sched_radix(x[:, None, :], rp, q, qi, 1, 0, 0, log_r,
                        torch.zeros((1, r), dtype=torch.int64))
        return y[:, 0, :].T.contiguous().to(I32)
    bc = col_block(log_r, c)
    col = torch.arange(c)[:, None, None]
    tid = torch.arange(r >> 4)[:, None]
    j = torch.arange(SCHED_VALS)[None, :]
    tile = torch.zeros((c // bc, (r + r // 16) * bc), dtype=torch.int64)
    passes = sched_passes(log_r)
    for i, (st, lr) in enumerate(passes):
        pos, blk = sched_pos(log_r, st, lr, tid, j)
        word = col_word(pos, col % bc, bc)
        y = x[:, pos] if i == 0 else tile[col // bc, word]
        y = sched_radix(y, rp, q, qi, 1, 0, st, lr, blk)
        if i < len(passes) - 1:
            tile[col // bc, word] = y
    out = torch.empty_like(x)
    out[:, pos] = y
    return out.T.contiguous().to(I32)


def ntt_row_plain(y, kt: FourStepKernelTables):
    """Plain version of `ntt_row` (same arguments and result)."""
    q, qi = u32(kt.q32), u32(kt.qinv32)
    x = mont_mul32(u32(y), u32(kt.t2_m), q, qi)
    return _ct_stages_axis0(x.T, u32(kt.rp_row_m), q, qi).T.reshape(-1)


def row_threads(log_c: int) -> int:
    """Threads that take one row of ntt_row: C / 16, one where C <= 16."""
    return 1 << (log_c - 4) if log_c > 4 else 1


def row_block(log_c: int, r: int) -> int:
    """Rows a block of ntt_row takes: as many whole rows as `ROW_THREADS`
    threads hold, one where a row takes more, at most R. R and the threads
    a row are powers of two, so the rows divide R, and a block stays
    within the kernel's launch bound (csrc/ntt.cu ``RowShape::kBlock``:
    one row's threads, or `ROW_MAX_THREADS` where that is more)."""
    return min(r, max(1, ROW_THREADS // row_threads(log_c)))


def row_word(p):
    """Word of row position p in ntt_row's exchange buffer (csrc/ntt.cu
    ``row_word``): one pad word after every 16; rows `row_words` apart."""
    return p + (p >> 4)


def row_words(c: int) -> int:
    return c + c // 16


def ntt_row_sched(y, kt: FourStepKernelTables):
    """`ntt_row` computed as its threads compute it, on int64 tensors with
    the kernel's index formulas: a row of C <= 16 values is one thread's
    single radix pass; above that, thread tid of a row loads the 16
    values `common.sched_pos` gives it in the first pass and multiplies
    them by t2 there, then runs each radix pass of the row's C points,
    the passes exchange values through each block's buffer of
    `row_block` rows laid out by `row_word`, and the last pass's values
    are stored where they lie."""
    tabs = kt.tabs
    r, c = tabs.r, tabs.c
    log_c = c.bit_length() - 1
    q, qi = u32(kt.q32), u32(kt.qinv32)
    rp = u32(kt.rp_row_m)[None, :]
    x, t2 = u32(y).reshape(r, c), u32(kt.t2_m).reshape(r, c)
    if log_c < 5:
        z = sched_radix(mont_mul32(x, t2, q, qi)[:, None, :], rp, q, qi, 1,
                        0, 0, log_c, torch.zeros((1, c), dtype=torch.int64))
        return z.reshape(-1)
    rows = row_block(log_c, r)
    threads = row_threads(log_c)
    row = torch.arange(r)[:, None, None]
    blk, word0 = row // rows, (row % rows) * row_words(c)
    tid = torch.arange(threads)[:, None]
    j = torch.arange(SCHED_VALS)[None, :]
    buf = torch.zeros((r // rows, rows * row_words(c)), dtype=torch.int64)
    passes = sched_passes(log_c)
    for i, (st, lr) in enumerate(passes):
        pos, sets = sched_pos(log_c, st, lr, tid, j)
        word = word0 + row_word(pos)
        if i == 0:
            v = mont_mul32(x[row, pos], t2[row, pos], q, qi)
        else:
            v = buf[blk, word]
        v = sched_radix(v, rp, q, qi, 1, 0, st, lr, sets)
        if i < len(passes) - 1:
            buf[blk, word] = v
    out = torch.empty_like(x)
    out[row, pos] = v
    return out.reshape(-1)


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


def ntt_col(a: torch.Tensor, kt: FourStepKernelTables,
            block_c: int) -> torch.Tensor:
    """Phase 1: a (N,) int64 viewed as (R, C) -> (R, C) int32, each column
    through its R-point NTT. `block_c`, the reference's column tile, must
    divide C as there; the kernel's tiling on Hopper is its own (R / 16
    threads a column, `col_block` columns a block; see `ntt_col_sched`)."""
    r, c = kt.tabs.r, kt.tabs.c
    _block(kt, block_c, c)
    check(a, "a", torch.int64, (r * c,))
    if not use_kernel(a, kt.t2_m):
        return ntt_col_plain(a, kt)
    log_r = r.bit_length() - 1
    if log_r > MAX_COL_LOG_R:
        raise ValueError(f"ntt_col: columns of R = {r} points; the kernel "
                         f"takes R <= {1 << MAX_COL_LOG_R}")
    y = torch.empty((r, c), dtype=I32, device=a.device)
    fn = build.bind(build.library("ntt.cu"), "rt_ntt_col", 5, 2)
    build.launch(fn, a.data_ptr(), y.data_ptr(), kt.rp_col_m.data_ptr(),
                 kt.q32.data_ptr(), kt.qinv32.data_ptr(), log_r, c)
    NTT_COL.launches += 1
    return y


def launch_info(log_r: int, c: int) -> Dict[str, int]:
    """The launch `ntt_col` makes for (R, C) = (2^log_r, c) on the
    current card, read from the built library without running it:
    `build.LAUNCH_KEYS` (cluster 1; max_active_clusters is blocks per SM
    times SMs)."""
    if not 0 <= log_r <= MAX_COL_LOG_R:
        raise ValueError(f"ntt_col: R = 2^{log_r} outside 1 to "
                         f"{1 << MAX_COL_LOG_R}")
    return build.launch_info("ntt.cu", "rt_ntt_col_info", log_r, c)


def ntt_row(y: torch.Tensor, kt: FourStepKernelTables,
            block_r: int) -> torch.Tensor:
    """Phases 2 and 3: y (R, C) int32 times t2, each row through its
    C-point NTT -> (N,) int64. `block_r`, the reference's row tile, must
    divide R as there; the kernel's tiling on Hopper is its own (C / 16
    threads a row, `row_block` rows a block; see `ntt_row_sched`)."""
    r, c = kt.tabs.r, kt.tabs.c
    log_c = c.bit_length() - 1
    _block(kt, block_r, r)
    check(y, "y", I32, (r, c))
    if not use_kernel(y, kt.t2_m):
        return ntt_row_plain(y, kt)
    _check_row(log_c)
    out = torch.empty(r * c, dtype=torch.int64, device=y.device)
    fn = build.bind(build.library("ntt.cu"), "rt_ntt_row", 6, 3)
    build.launch(fn, y.data_ptr(), kt.t2_m.data_ptr(), kt.rp_row_m.data_ptr(),
                 kt.q32.data_ptr(), kt.qinv32.data_ptr(), out.data_ptr(), r,
                 log_c, row_block(log_c, r))
    NTT_ROW.launches += 1
    return out


def _check_row(log_c: int) -> None:
    if not 0 <= log_c <= MAX_ROW_LOG_C:
        raise ValueError(f"ntt_row: rows of C = 2^{log_c} points; the "
                         f"kernel takes C <= {1 << MAX_ROW_LOG_C}")


def row_launch_info(log_c: int, r: int) -> Dict[str, int]:
    """The launch `ntt_row` makes for (R, C) = (r, 2^log_c) on the current
    card (`row_block` rows a block), read from the built library without
    running it: `build.LAUNCH_KEYS` as `launch_info`."""
    _check_row(log_c)
    return build.launch_info("ntt.cu", "rt_ntt_row_info", r, log_c,
                             row_block(log_c, r))


def ntt_four_step(a: torch.Tensor, kt: FourStepKernelTables, *,
                  block_c: int = 128, block_r: int = 8) -> torch.Tensor:
    """a: (N,) int64 coefficients < q -> (N,) int64 in kernel order. The
    blocks are clamped to R and C and must divide them (ValueError)."""
    _block(kt, block_r, kt.tabs.r)
    return ntt_row(ntt_col(a, kt, block_c), kt, block_r)
