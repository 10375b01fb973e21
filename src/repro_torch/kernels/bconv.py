"""K6: the BConv accumulation, the CUDA kernel and its plain version.

    out[d, n] = sum_j v[j, n] * w[j, d]  (mod p_d)

Replaces `repro/kernels/bconv.py::_bconv_kernel` (``bconv.py:27``) and
``_bconv_kernel_lazy`` (``bconv.py:39``), launched by ``bconv_pallas``.
Source: ``repro_torch/csrc/bconv.cu``, one template with a ``lazy`` flag,
counted as two kernels (``bconv`` and ``bconv_lazy``). Bound by bytes;
see the source for the design: a grid of column tiles by groups of
`GROUP` destination primes, each thread holding its columns' S source
values in registers (S a template argument, 1 to `MAX_S`), two adjacent
columns a thread in 16-byte words for an even N. `bconv_sched` models
that grid and mapping on the CPU.

Eager reduces and adds every product; lazy adds two reduced products,
folds the pair once and adds it (what the reference code does). Both are
exact, so both return the same values. Sums are formed in 64 bits: p_d
reaches 2^32 in the staged keyswitch (fault F2 of the reference, whose
u32 pair sum wraps there).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (addmod32, check, mont_mul32,
                                        register_kernel, u32, use_kernel)

SRC = "src/repro_torch/csrc/bconv.cu"
BCONV = register_kernel("bconv", SRC, "src/repro/kernels/bconv.py:27")
BCONV_LAZY = register_kernel("bconv_lazy", SRC,
                             "src/repro/kernels/bconv.py:39")

# csrc/bconv.cu's launch constants
THREADS = 256                # threads of a block where the grid is full
MIN_THREADS = 32
GROUP = 8                    # destination primes a block takes
MAX_S = 7                    # largest source basis instantiated
SPREAD = 128                 # fewer blocks than this: halve the block


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
    _check_s(s)
    out = torch.empty((d, n), dtype=torch.int64, device=v.device)
    fn = build.bind(build.library("bconv.cu"), "rt_bconv", 5, 4)
    build.launch(fn, v.data_ptr(), w_mont.data_ptr(), p32.data_ptr(),
                 pinv32.data_ptr(), out.data_ptr(), s, d, n, int(lazy))
    (BCONV_LAZY if lazy else BCONV).launches += 1
    return out


def _check_s(s: int) -> None:
    if not 1 <= s <= MAX_S:
        raise ValueError(f"bconv: {s} source primes; the kernel is "
                         f"instantiated for 1 to {MAX_S}")


def launch_info(s: int, d: int, n: int, lazy: bool = False
                ) -> Dict[str, int]:
    """The launch `bconv_mont` makes for (S, D, N) on the current card
    with 16-byte aligned rows, read from the built library without
    running it: `build.LAUNCH_KEYS` (cluster 1; max_active_clusters is
    blocks per SM times SMs)."""
    _check_s(s)
    return build.launch_info("bconv.cu", "rt_bconv_info", s, d, n,
                             int(lazy))


@dataclasses.dataclass(frozen=True)
class BConvSched:
    """The grid of csrc/bconv.cu for S sources, D outputs and n columns,
    and the work each of its threads does."""
    s: int
    d: int
    n: int
    vec: int                 # columns a thread takes: 2 = 16-byte words
    threads: int             # threads a block
    grid: Tuple[int, int]    # (column tiles, groups of GROUP outputs)

    def cols(self) -> torch.Tensor:
        """(tiles, threads, vec): the columns thread t of tile x takes,
        (x * threads + t) * vec and the vec - 1 after it."""
        pair = (torch.arange(self.grid[0])[:, None] * self.threads
                + torch.arange(self.threads)[None, :])
        return (pair * self.vec)[..., None] + torch.arange(self.vec)

    def live(self) -> torch.Tensor:
        """(tiles, threads): a thread works when its first column is < n."""
        return self.cols()[..., 0] < self.n

    def rows(self) -> torch.Tensor:
        """(groups, GROUP): output row of each slot of each group; a slot
        at D or above is skipped."""
        return (torch.arange(self.grid[1])[:, None] * GROUP
                + torch.arange(GROUP)[None, :])

    def loads(self) -> torch.Tensor:
        """(live threads, S, vec) int64 word of v each load of a live
        thread reads: one `vec`-word access a source row."""
        c = self.cols()[self.live()]
        return torch.arange(self.s)[None, :, None] * self.n + c[:, None, :]

    def stores(self) -> torch.Tensor:
        """(stores, vec, 2): the (row, column) pairs each store writes,
        one store a live thread and live slot, in the kernel's order."""
        c = self.cols()[self.live()]
        rows = self.rows()
        out = []
        for gy in range(self.grid[1]):
            for d in rows[gy][rows[gy] < self.d].tolist():
                out.append(torch.stack(
                    [torch.full_like(c, d), c], -1))
        return torch.cat(out)

    def run(self, v, w_mont, p32, pinv32, lazy: bool = False):
        """K6 computed as these threads compute it: each live thread
        reads its S x vec values once, then for each output of its group
        sums the S products in the variant's schedule and stores them."""
        p, pi, w = u32(p32), u32(pinv32), u32(w_mont)
        live_cols = self.cols()[self.live()]
        x = v.reshape(-1)[self.loads()]                # (L, S, vec)
        out = torch.full((self.d, self.n), -1, dtype=torch.int64)
        for d in range(self.d):
            def term(j):
                return mont_mul32(x[:, j], w[d, j], p[d], pi[d])
            acc = torch.zeros_like(x[:, 0])
            paired = self.s - self.s % 2 if lazy else 0
            for j in range(0, paired, 2):
                pair = term(j) + term(j + 1)                 # < 2p
                acc = addmod32(acc, torch.where(pair >= p[d], pair - p[d],
                                                pair), p[d])
            for j in range(paired, self.s):
                acc = addmod32(acc, term(j), p[d])
            out[d, live_cols] = acc
        return out


def bconv_sched(s: int, d: int, n: int, aligned: bool = True
                ) -> BConvSched:
    """csrc/bconv.cu's launch for S sources, D outputs, n columns: two
    columns a thread when n is even and the rows' bases are 16-byte
    aligned (`aligned`), else one; `THREADS` threads a block, halved
    down to `MIN_THREADS` while the grid has fewer than `SPREAD` blocks."""
    _check_s(s)
    vec = 2 if n % 2 == 0 and aligned else 1
    pairs = -(-n // vec)
    groups = -(-d // GROUP)
    threads = THREADS
    while threads > MIN_THREADS and -(-pairs // threads) * groups < SPREAD:
        threads //= 2
    return BConvSched(s, d, n, vec, threads, (-(-pairs // threads), groups))
