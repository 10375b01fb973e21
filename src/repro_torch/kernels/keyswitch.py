"""Fused CKKS keyswitch: kernels K1-K3, their plain versions, and the
4-launch pipeline built from them.

Replaces `repro/kernels/keyswitch.py`. Generalized dnum key switching
(core/ops.py::key_switch) is, per digit, ModUp = iNTT -> BConv -> NTT,
then the evk inner product, then ModDown. This module runs the whole of
it as FOUR launches, whatever the digit count, limb count or batch:

  A  K1 ``intt_scale``        grid (chunks, l, B) in clusters of the
     chunks of a row: inverse NTT of every Q limb with n^{-1}·qhat^{-1}
     folded into one Montgomery multiply (digits partition the Q limbs,
     so this is ModUp's front half for all digits)
  B  K2 ``bconv_ntt_mulacc``  grid (chunks, B, T) in clusters of the
     chunks of a row: per target limb, the BConv sum, the forward NTT and
     the evk multiply-accumulate of both key components, with the digit
     loop inside the block and the accumulators on chip
  C1 K1 ``intt_scale``        grid (chunks, n_p, 2B): inverse NTT of the
     special limbs of both accumulators, scale n^{-1}·phat^{-1}
  C2 K3 ``moddown``           grid (chunks, l, 2B) in clusters of the
     chunks of a row: BConv P->Q, forward NTT, subtraction from the Q
     limbs, times P^{-1}

A rescale is a ModDown by one prime, the last Q limb: `FusedKeySwitch.
rescale` runs it as the same tail, TWO launches: K1 on that limb (scale
n^{-1}), then K3 with it as a one-limb "special" basis (BConv weight 1,
times q_l^{-1}), bit-identical to ``core/ops.rescale``. Its launches
count as ``intt_scale(rescale)`` and ``moddown(rescale)``, apart from a
keyswitch's.

``keyswitch_staged`` runs the same keyswitch as one dispatch per stage
(7·digits + 10), through K4-K6 and the library NTTs: the baseline the
fused pipeline is measured against (benchmarks/fig14_kernels.py).

The digit-limb "copy" of the reference ModUp needs no special case: for a
target limb inside the source digit every cross term of the BConv sum
vanishes and the diagonal term reproduces the limb, so the uniform path
is bit-identical to ``core/ops.key_switch``.

Each wrapper takes int32 tensors holding u32 residues. On CPU tensors it
runs its plain version (plain torch, the same Montgomery arithmetic on
int64); on CUDA tensors it launches its kernel from
``repro_torch/csrc/keyswitch.cu`` or raises. The kernels are bound by
bytes moved and integer multiplies; see that source for the design.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from repro_torch.core import modarith as ma
from repro_torch.kernels import build
from repro_torch.kernels import ops as kops
from repro_torch.kernels.bconv import bconv_mont
from repro_torch.kernels.common import (SCHED_VALS, addmod32, as_i32,
                                        check, mont_mul32, qinv_neg32,
                                        record_dispatch, register_kernel,
                                        sched_passes, sched_phys, sched_pos,
                                        sched_radix, sched_run_pos, submod32,
                                        to_mont_int, u32, use_kernel)

I32 = torch.int32
SRC = "src/repro_torch/csrc/keyswitch.cu"
# K1 has three launch shapes and K3 two, each counted apart: K1 stage A
# (every Q limb of the batch) and C1 (the special limbs of both
# accumulators) and K3 of a keyswitch; K1 on the last Q limb and K3 over
# that one-limb basis of a rescale
INTT_SCALE = register_kernel("intt_scale", SRC,
                             "src/repro/kernels/keyswitch.py:103")
INTT_SCALE_C1 = register_kernel("intt_scale(C1)", SRC,
                                "src/repro/kernels/keyswitch.py:103")
BCONV_NTT_MULACC = register_kernel("bconv_ntt_mulacc", SRC,
                                   "src/repro/kernels/keyswitch.py:113")
MODDOWN = register_kernel("moddown", SRC, "src/repro/kernels/keyswitch.py:144")
INTT_SCALE_RESCALE = register_kernel("intt_scale(rescale)", SRC,
                                     "src/repro/kernels/keyswitch.py:103")
MODDOWN_RESCALE = register_kernel("moddown(rescale)", SRC,
                                  "src/repro/kernels/keyswitch.py:144")

MAX_LOG_N = 16          # csrc/common.cuh: at most 4 chunks of 16384
MIN_LOG_N = 5           # K1-K3: a chunk of at least 32 words (2 threads)


def _check_n(n: int) -> int:
    log_n = n.bit_length() - 1
    if n != 1 << log_n or log_n > MAX_LOG_N:
        raise ValueError(f"ring degree {n}: the keyswitch kernels take a "
                         f"power of two up to 2^{MAX_LOG_N}")
    return log_n


def _check_cluster_operands(log_n: int, *tensors) -> None:
    """K1-K3 move rows in 16-byte runs and split a row into chunks of at
    least 32 words."""
    if log_n < MIN_LOG_N:
        raise ValueError(f"ring degree 2^{log_n}: K1-K3 take at least "
                         f"2^{MIN_LOG_N}")
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("K1-K3 operands must start 16-byte aligned")


# ---------------------------------------------------------------------------
# plain butterflies (batched over leading dims; per-row twiddles)
# ---------------------------------------------------------------------------

def _ct_stages(x, rp, q, qi):
    """Harvey CT forward butterflies along the last axis of x (..., R, n)
    with per-row Montgomery twiddles rp (R, n); q, qi (R, 1)."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    qq, qiq = q[..., None], qi[..., None]
    m = 1
    while m < n:
        t = n // (2 * m)
        xr = x.reshape(*lead, m, 2 * t)
        u = xr[..., :t]
        v = mont_mul32(xr[..., t:], rp[:, m:2 * m, None], qq, qiq)
        x = torch.cat([addmod32(u, v, qq), submod32(u, v, qq)],
                      dim=-1).reshape(*lead, n)
        m *= 2
    return x


def _gs_stages(x, irp, q, qi):
    """Gentleman-Sande inverse butterflies without the n^{-1} scale."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    qq, qiq = q[..., None], qi[..., None]
    m = n // 2
    while m >= 1:
        t = n // (2 * m)
        xr = x.reshape(*lead, m, 2 * t)
        u = xr[..., :t]
        v = xr[..., t:]
        d = mont_mul32(submod32(u, v, qq), irp[:, m:2 * m, None], qq, qiq)
        x = torch.cat([addmod32(u, v, qq), d], dim=-1).reshape(*lead, n)
        m //= 2
    return x


# ---------------------------------------------------------------------------
# the kernels' NTT schedules, modelled on the CPU (for the tests)
# ---------------------------------------------------------------------------
# K1 runs the inverse NTT of a row, K2 and K3 the forward NTT, as NCH chunk
# blocks of one thread-block cluster (csrc/common.cuh::intt_cluster and
# ::ntt_fwd_cluster). The functions below are those schedules on int64
# tensors, with the same index formulas (kernels/common.py::sched_*), so
# that their index math is held to `_gs_stages` and `_ct_stages` where no
# card is.

def ntt_fwd_sched(x, rp, q, qi, nch: int):
    """x (R, n) residues (int64), rp (R, n) Montgomery twiddles, q, qi
    (R, 1) -> (R, n): the forward NTT of `_ct_stages`, computed as K2 and
    K3 compute it: each of the NCH chunk blocks forms its chunk of x once
    into its padded buffer; after a cluster barrier every thread gathers
    the NCH values i + s·C of its 16 positions from the peers and runs the
    cross-chunk stages keeping its own chunk's half; after a second
    barrier each block runs the in-chunk radix passes on its own buffer."""
    rows, n = x.shape
    c_len = n // nch
    log_c = c_len.bit_length() - 1
    tid = torch.arange(c_len >> 4)[:, None]
    j = torch.arange(SCHED_VALS)[None, :]
    qq, qiq = q[:, :, None], qi[:, :, None]
    run = sched_run_pos(log_c, tid, j)
    bufs = torch.zeros((nch, rows, sched_phys(c_len - 1) + 1),
                       dtype=x.dtype)
    for c in range(nch):
        bufs[c][:, sched_phys(run)] = x[:, c * c_len + run]
    passes = sched_passes(log_c)
    p0, _ = sched_pos(log_c, *passes[0], tid, j)
    gathered = []
    for c in range(nch):                  # between the two cluster barriers
        z = [bufs[s][:, sched_phys(p0)] for s in range(nch)]
        m = 1
        while m < nch:
            tt = nch // (2 * m)
            w = rp[:, m + c // (2 * tt)][:, None, None]
            op = submod32 if (c // tt) & 1 else addmod32
            z = [op(z[k], mont_mul32(z[k + tt], w, qq, qiq), qq)
                 for k in range(tt)]
            m *= 2
        gathered.append(z[0])
    out = torch.empty_like(x)
    for c in range(nch):                  # each block on its own buffer
        y = gathered[c]
        for i, (st, lr) in enumerate(passes):
            pos, blk = sched_pos(log_c, st, lr, tid, j)
            if i:
                y = bufs[c][:, sched_phys(pos)]
            y = sched_radix(y, rp, qq, qiq, nch, c, st, lr, blk)
            if i < len(passes) - 1:
                bufs[c][:, sched_phys(pos)] = y
        out[:, c * c_len + pos] = y
    return out


def intt_sched(x, irp, q, qi, nch: int):
    """x (R, n) residues (int64), irp (R, n) inverse Montgomery twiddles,
    q, qi (R, 1) -> (R, n): the GS stages of `_gs_stages` (no n^{-1}),
    computed as K1 computes them: each of the NCH chunk blocks loads its
    threads' contiguous sets from x, runs the in-chunk radix passes from
    the smallest stride up through its padded buffer and, for NCH > 1,
    leaves its chunk there; after a cluster barrier every thread gathers
    the NCH values i + s·C of its 16 positions from the peers and runs the
    cross-chunk stages keeping its own chunk's output."""
    rows, n = x.shape
    c_len = n // nch
    log_c = c_len.bit_length() - 1
    tid = torch.arange(c_len >> 4)[:, None]
    j = torch.arange(SCHED_VALS)[None, :]
    qq, qiq = q[:, :, None], qi[:, :, None]
    passes = sched_passes(log_c)[::-1]
    bufs = torch.zeros((nch, rows, sched_phys(c_len - 1) + 1),
                       dtype=x.dtype)
    ys = []
    for c in range(nch):                  # before the first cluster barrier
        for i, (st, lr) in enumerate(passes):
            pos, blk = sched_pos(log_c, st, lr, tid, j)
            y = (x[:, c * c_len + pos] if i == 0
                 else bufs[c][:, sched_phys(pos)])
            y = sched_radix(y, irp, qq, qiq, nch, c, st, lr, blk,
                            inverse=True)
            if i < len(passes) - 1 or nch > 1:
                bufs[c][:, sched_phys(pos)] = y
        ys.append(y)
    out = torch.empty_like(x)
    for c in range(nch):                  # between the two cluster barriers
        y = ys[c]
        if nch > 1:
            # chunk stride t = 2^bit: chunks s, s + t under irp[m + g];
            # block c keeps the sum where bit `bit` of c is 0
            z = [bufs[s][:, sched_phys(pos)] for s in range(nch)]
            m, bit = nch // 2, 0
            while m >= 1:
                keep_diff = (c >> bit) & 1
                z = [mont_mul32(submod32(z[2 * g], z[2 * g + 1], qq),
                                irp[:, m + g][:, None, None], qq, qiq)
                     if keep_diff else addmod32(z[2 * g], z[2 * g + 1], qq)
                     for g in range(m)]
                m, bit = m // 2, bit + 1
            y = z[0]
        out[:, c * c_len + pos] = y
    return out


# ---------------------------------------------------------------------------
# K1: inverse NTT + per-limb scale
# ---------------------------------------------------------------------------

def intt_scale_plain(x, row0, n_rows, irp_m, q32, qi32, scale_m):
    q, qi = u32(q32)[:, None], u32(qi32)[:, None]
    y = _gs_stages(u32(x[:, row0:row0 + n_rows]), u32(irp_m), q, qi)
    return mont_mul32(y, u32(scale_m)[:, None], q, qi).to(I32)


def intt_scale(x: torch.Tensor, row0: int, n_rows: int, irp_m, q32, qi32,
               scale_m, *, counter=INTT_SCALE) -> torch.Tensor:
    """Rows [row0, row0+n_rows) of x (R, S, N): GS inverse NTT (no n^{-1})
    then a Montgomery multiply by scale_m[j] -> (R, n_rows, N) int32.
    A kernel launch adds one to `counter` (INTT_SCALE, INTT_SCALE_C1 or
    INTT_SCALE_RESCALE)."""
    r, s, n = x.shape
    log_n = _check_n(n)
    if not 0 <= row0 <= row0 + n_rows <= s:
        raise ValueError(f"intt_scale: rows {row0}+{n_rows} outside {s}")
    check(x, "x", I32, (r, s, n))
    check(irp_m, "irp_m", I32, (n_rows, n))
    for name, t in (("q32", q32), ("qi32", qi32), ("scale_m", scale_m)):
        check(t, name, I32, (n_rows,))
    if not use_kernel(x, irp_m, q32, qi32, scale_m):
        return intt_scale_plain(x, row0, n_rows, irp_m, q32, qi32, scale_m)
    out = torch.empty((r, n_rows, n), dtype=I32, device=x.device)
    _check_cluster_operands(log_n, x, out)
    fn = build.bind(build.library("keyswitch.cu"), "rt_intt_scale", 6, 5)
    build.launch(fn, x.data_ptr(), out.data_ptr(), irp_m.data_ptr(),
                 q32.data_ptr(), qi32.data_ptr(), scale_m.data_ptr(),
                 r, s, row0, n_rows, log_n)
    counter.launches += 1
    return out


# ---------------------------------------------------------------------------
# K2: BConv + forward NTT + evk multiply-accumulate, digit loop inside
# ---------------------------------------------------------------------------

def bconv_ntt_mulacc_plain(v, w_m, rp_m, q32, qi32, ksk_m, alpha):
    b, l, n = v.shape
    d_n, _, t_n = w_m.shape
    q, qi = u32(q32)[:, None], u32(qi32)[:, None]
    v64, w, rp = u32(v), u32(w_m), u32(rp_m)
    acc = [None, None]
    for d in range(d_n):
        s = torch.zeros((b, t_n, n), dtype=torch.int64, device=v.device)
        for jl, j in enumerate(range(d * alpha, min((d + 1) * alpha, l))):
            s = addmod32(s, mont_mul32(v64[:, j:j + 1], w[d, jl][:, None],
                                       q, qi), q)
        raised = _ct_stages(s, rp, q, qi)
        for k in range(2):
            p = mont_mul32(raised, u32(ksk_m[d, k]), q, qi)
            acc[k] = p if d == 0 else addmod32(acc[k], p, q)
    return torch.stack(acc).to(I32)


def bconv_ntt_mulacc(v: torch.Tensor, w_m, rp_m, q32, qi32, ksk_m,
                     alpha: int) -> torch.Tensor:
    """v (B, l, N) ModUp front halves; w_m (D, alpha, T) BConv weights
    (Montgomery, w.r.t. each target prime); rp_m (T, N) forward twiddles;
    q32/qi32 (T,); ksk_m (D, 2, T, N) evk -> (2, B, T, N) int32: the two
    accumulators sum_d NTT(BConv_d(v)) * ksk[d, k]."""
    b, l, n = v.shape
    d_n, _, t_n = w_m.shape
    log_n = _check_n(n)
    if not (d_n - 1) * alpha < l <= d_n * alpha:
        raise ValueError(f"bconv_ntt_mulacc: {d_n} digits of {alpha} do "
                         f"not cover {l} limbs")
    check(v, "v", I32, (b, l, n))
    check(w_m, "w_m", I32, (d_n, alpha, t_n))
    check(rp_m, "rp_m", I32, (t_n, n))
    check(q32, "q32", I32, (t_n,))
    check(qi32, "qi32", I32, (t_n,))
    check(ksk_m, "ksk_m", I32, (d_n, 2, t_n, n))
    if not use_kernel(v, w_m, rp_m, q32, qi32, ksk_m):
        return bconv_ntt_mulacc_plain(v, w_m, rp_m, q32, qi32, ksk_m, alpha)
    out = torch.empty((2, b, t_n, n), dtype=I32, device=v.device)
    _check_cluster_operands(log_n, v, ksk_m, out)
    fn = build.bind(build.library("keyswitch.cu"), "rt_bconv_ntt_mulacc",
                    7, 6)
    build.launch(fn, v.data_ptr(), w_m.data_ptr(), rp_m.data_ptr(),
                 q32.data_ptr(), qi32.data_ptr(), ksk_m.data_ptr(),
                 out.data_ptr(), b, l, t_n, d_n, alpha, log_n)
    BCONV_NTT_MULACC.launches += 1
    return out


# ---------------------------------------------------------------------------
# K3: ModDown tail
# ---------------------------------------------------------------------------

def moddown_plain(g, vp, wpq_m, rp_m, q32, qi32, pinv_m):
    n_p, l = wpq_m.shape
    q, qi = u32(q32[:l])[:, None], u32(qi32[:l])[:, None]
    vp64, w = u32(vp), u32(wpq_m)
    s = torch.zeros((g.shape[0], l, g.shape[2]), dtype=torch.int64,
                    device=g.device)
    for j in range(n_p):
        s = addmod32(s, mont_mul32(vp64[:, j:j + 1], w[j][:, None], q, qi),
                     q)
    conv = _ct_stages(s, u32(rp_m[:l]), q, qi)
    diff = submod32(u32(g[:, :l]), conv, q)
    return mont_mul32(diff, u32(pinv_m)[:, None], q, qi).to(I32)


def moddown(g: torch.Tensor, vp, wpq_m, rp_m, q32, qi32,
            pinv_m, *, counter=MODDOWN) -> torch.Tensor:
    """g (2B, T, N) accumulators; vp (2B, n_p, N) their scaled P-limb
    inverse NTTs; wpq_m (n_p, l); rp_m (T, N), q32/qi32 (T,) of the target
    basis (the first l rows are the Q limbs); pinv_m (l,) ->
    (2B, l, N) int32 = (g_Q - NTT(BConv_{P->Q}(vp))) * P^{-1}.
    A kernel launch adds one to `counter` (MODDOWN or MODDOWN_RESCALE)."""
    b2, t_n, n = g.shape
    n_p, l = wpq_m.shape
    log_n = _check_n(n)
    check(g, "g", I32, (b2, t_n, n))
    check(vp, "vp", I32, (b2, n_p, n))
    check(wpq_m, "wpq_m", I32, (n_p, l))
    check(rp_m, "rp_m", I32, (t_n, n))
    check(q32, "q32", I32, (t_n,))
    check(qi32, "qi32", I32, (t_n,))
    check(pinv_m, "pinv_m", I32, (l,))
    if l > t_n:
        raise ValueError(f"moddown: {l} Q limbs in a basis of {t_n}")
    if not use_kernel(g, vp, wpq_m, rp_m, q32, qi32, pinv_m):
        return moddown_plain(g, vp, wpq_m, rp_m, q32, qi32, pinv_m)
    out = torch.empty((b2, l, n), dtype=I32, device=g.device)
    _check_cluster_operands(log_n, g, vp, out)
    fn = build.bind(build.library("keyswitch.cu"), "rt_moddown", 8, 5)
    build.launch(fn, g.data_ptr(), vp.data_ptr(), wpq_m.data_ptr(),
                 rp_m.data_ptr(), q32.data_ptr(), qi32.data_ptr(),
                 pinv_m.data_ptr(), out.data_ptr(), b2, l, t_n, n_p, log_n)
    counter.launches += 1
    return out


def launch_info(name: str, n: int, *dims: int) -> Dict[str, int]:
    """The launch K1 (`name` "intt_scale", dims R, S, n_rows), K2
    ("bconv_ntt_mulacc", dims B, l, T, D, alpha) or K3 ("moddown", dims
    2B, l, T, n_p) makes at ring degree n on the current card, without
    running it: grid, cluster size, threads, dynamic shared memory,
    cudaOccupancyMaxActiveClusters (blocks per SM times SMs where there
    is no cluster), registers and local memory per thread."""
    entry = {"intt_scale": ("rt_intt_scale_info", 3),
             "bconv_ntt_mulacc": ("rt_bconv_ntt_mulacc_info", 5),
             "moddown": ("rt_moddown_info", 4)}[name]
    if len(dims) != entry[1]:
        raise ValueError(f"{name}: {entry[1]} dims, got {len(dims)}")
    return build.launch_info("keyswitch.cu", entry[0], *dims, _check_n(n))


# ---------------------------------------------------------------------------
# host-precomputed per-level tables
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _LevelTables:
    """Device tables (int32, u32 residues) for one level's target basis."""
    n_digits: int
    alpha: int                    # digit size (the tail digit may be short)
    n_p: int
    # stage A (Q-limb iNTT + digit-local qhat^{-1} scale)
    q_irp_m: torch.Tensor         # (l, N)
    q_q32: torch.Tensor           # (l,)
    q_qi32: torch.Tensor          # (l,)
    q_scale_m: torch.Tensor       # (l,)  n^{-1}·qhat^{-1}, Montgomery
    # stage B (target-limb BConv + NTT + evk mulacc)
    w_m: torch.Tensor             # (D, alpha, T) Montgomery w.r.t. target
    rp_m: torch.Tensor            # (T, N) forward twiddles, Montgomery
    t_q32: torch.Tensor           # (T,)
    t_qi32: torch.Tensor          # (T,)
    # ModDown
    p_irp_m: torch.Tensor         # (n_p, N)
    p_q32: torch.Tensor           # (n_p,)
    p_qi32: torch.Tensor          # (n_p,)
    p_scale_m: torch.Tensor       # (n_p,) n^{-1}·phat^{-1}, Montgomery
    wpq_m: torch.Tensor           # (n_p, l) Montgomery w.r.t. q
    pinv_m: torch.Tensor          # (l,) P^{-1} mod q, Montgomery


@dataclasses.dataclass
class _RescaleTables:
    """Device tables (int32, u32 residues) of a rescale from one level."""
    irp_m: torch.Tensor           # (1, N) inverse twiddles of q_l
    q_l32: torch.Tensor           # (1,)
    q_l_qi32: torch.Tensor        # (1,)
    scale_m: torch.Tensor         # (1,)  n^{-1} mod q_l, Montgomery
    w_m: torch.Tensor             # (1, l) 1 mod q_j, Montgomery
    rp_m: torch.Tensor            # (l + 1, N) forward twiddles
    q32: torch.Tensor             # (l + 1,)
    qi32: torch.Tensor            # (l + 1,)
    qlinv_m: torch.Tensor         # (l,) q_l^{-1} mod q_j, Montgomery


class FusedKeySwitch:
    """Executes the fused keyswitch pipeline against one CkksContext.

    Tables are built once per level; evaluation keys are put in
    Montgomery form once per (key identity, level) and kept as int32;
    every evk (relin and all Galois keys) shares the same tables. With
    ``obs`` (an `obs.EngineObs`, set by the engine that owns this) a
    conversion records an ``engine.ksk_mont`` span.
    """

    DISPATCHES_PER_APPLY = 4      # kernel launches per keyswitch
    DISPATCHES_PER_RESCALE = 2    # K1 on the last limb, then K3

    def __init__(self, ctx):
        self.ctx = ctx
        self.obs = None
        self._tabs: Dict[int, _LevelTables] = {}
        self._rescale_tabs: Dict[int, _RescaleTables] = {}
        self._ksk_m: Dict[Tuple, torch.Tensor] = {}
        self._twiddles = None

    # -- tables --------------------------------------------------------------

    def _mont_twiddles(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Forward and inverse twiddles of every limb, Montgomery, int32."""
        if self._twiddles is None:
            ctx = self.ctx
            rm = ctx._t([(1 << 32) % p for p in ctx.primes])[:, None]
            q = ctx.q_all[:, None]
            self._twiddles = tuple(
                ma.mulmod(tw, rm, q).to(I32)
                for tw in (ctx.tables.root_powers,
                           ctx.tables.inv_root_powers))
        return self._twiddles

    def _tables(self, level: int) -> _LevelTables:
        t = self._tabs.get(level)
        if t is not None:
            return t
        ctx = self.ctx
        dev = ctx.device
        n = ctx.n
        l = level + 1
        n_p = ctx.n_p
        digits = ctx.params.digit_indices(level)
        alpha = ctx.params.alpha
        target = list(range(l)) + ctx.p_idx()
        t_primes = [ctx.primes[i] for i in target]
        rp_all, irp_all = self._mont_twiddles()

        q_scale = [0] * l
        w = [[[0] * len(target) for _ in range(alpha)] for _ in digits]
        for d, dig in enumerate(digits):
            big_qd = 1
            for j in dig:
                big_qd *= ctx.primes[j]
            for jl, j in enumerate(dig):
                qj = ctx.primes[j]
                qhat = big_qd // qj
                q_scale[j] = to_mont_int(
                    pow(n, -1, qj) * pow(qhat % qj, -1, qj), qj)
                for ti, p in enumerate(t_primes):
                    w[d][jl][ti] = to_mont_int(qhat, p)

        p_glob = ctx.p_idx()
        big_p = ctx.big_p
        p_scale, wpq = [], []
        for g in p_glob:
            p = ctx.primes[g]
            phat = big_p // p
            p_scale.append(to_mont_int(pow(n, -1, p) * pow(phat % p, -1, p),
                                       p))
            wpq.append([to_mont_int(phat, ctx.primes[j]) for j in range(l)])
        pinv = [to_mont_int(pow(big_p % ctx.primes[j], -1, ctx.primes[j]),
                            ctx.primes[j]) for j in range(l)]

        def qi(primes):
            return as_i32([qinv_neg32(p) for p in primes], dev)

        t = _LevelTables(
            n_digits=len(digits), alpha=alpha, n_p=n_p,
            q_irp_m=irp_all[:l].contiguous(),
            q_q32=as_i32(ctx.primes[:l], dev),
            q_qi32=qi(ctx.primes[:l]),
            q_scale_m=as_i32(q_scale, dev),
            w_m=as_i32(w, dev),
            rp_m=rp_all[ctx.index(target)].contiguous(),
            t_q32=as_i32(t_primes, dev),
            t_qi32=qi(t_primes),
            p_irp_m=irp_all[ctx.index(p_glob)].contiguous(),
            p_q32=as_i32([ctx.primes[g] for g in p_glob], dev),
            p_qi32=qi([ctx.primes[g] for g in p_glob]),
            p_scale_m=as_i32(p_scale, dev),
            wpq_m=as_i32(wpq, dev),
            pinv_m=as_i32(pinv, dev),
        )
        self._tabs[level] = t
        return t

    def _rescale_tables(self, level: int) -> _RescaleTables:
        t = self._rescale_tabs.get(level)
        if t is not None:
            return t
        ctx = self.ctx
        dev = ctx.device
        q_l = ctx.primes[level]
        low = ctx.primes[:level]
        rp_all, irp_all = self._mont_twiddles()
        t = _RescaleTables(
            irp_m=irp_all[level:level + 1].contiguous(),
            q_l32=as_i32([q_l], dev),
            q_l_qi32=as_i32([qinv_neg32(q_l)], dev),
            scale_m=as_i32([to_mont_int(pow(ctx.n, -1, q_l), q_l)], dev),
            w_m=as_i32([[to_mont_int(1, q) for q in low]], dev),
            rp_m=rp_all[:level + 1].contiguous(),
            q32=as_i32(ctx.primes[:level + 1], dev),
            qi32=as_i32([qinv_neg32(q) for q in ctx.primes[:level + 1]],
                        dev),
            qlinv_m=as_i32([to_mont_int(pow(q_l, -1, q), q) for q in low],
                           dev),
        )
        self._rescale_tabs[level] = t
        return t

    def rescale(self, data: torch.Tensor, level: int) -> torch.Tensor:
        """Rescale (B, 2, level+1, N) int64 NTT-domain ciphertexts by
        their last prime: two launches, K1 (inverse NTT of the last limb)
        and K3 (its residues NTT'd into each remaining limb, subtracted,
        times q_l^{-1}). Returns (B, 2, level, N) int64, bit-identical to
        core/ops.rescale."""
        if level < 1:
            raise ValueError("rescale: no levels left")
        b, _, l1, n = data.shape
        if l1 != level + 1:
            raise ValueError(f"rescale: {l1} limbs at level {level}")
        t = self._rescale_tables(level)
        record_dispatch(self.DISPATCHES_PER_RESCALE)
        x = data.reshape(2 * b, l1, n).to(I32).contiguous()
        last = intt_scale(x, level, 1, t.irp_m, t.q_l32, t.q_l_qi32,
                          t.scale_m, counter=INTT_SCALE_RESCALE)
        out = moddown(x, last, t.w_m, t.rp_m, t.q32, t.qi32, t.qlinv_m,
                      counter=MODDOWN_RESCALE)
        return u32(out).reshape(b, 2, level, n)

    def ksk_mont(self, key: Tuple, level: int,
                 ksk_data: torch.Tensor) -> torch.Tensor:
        """Target-basis slice of an evk in Montgomery form, cached per
        (stable key identity, level): (D, 2, T, N) int32."""
        k = (key, level)
        m = self._ksk_m.get(k)
        if m is not None:
            return m
        o = self.obs
        if o is not None:
            o.begin("engine.ksk_mont", key=key, level=level)
        ctx = self.ctx
        t = self._tables(level)
        tix = ctx.index(list(range(level + 1)) + ctx.p_idx())
        rm = ctx._t([(1 << 32) % ctx.primes[g] for g in tix.tolist()])
        sel = ksk_data[: t.n_digits][:, :, tix]
        m = ma.mulmod(sel, rm[:, None], ctx.q_all[tix][:, None]).to(I32)
        if o is not None:
            o.end()
        self._ksk_m[k] = m
        return m

    # -- pipeline ------------------------------------------------------------

    def steps(self, d2: torch.Tensor, level: int, ksk_m: torch.Tensor
              ) -> Tuple[Tuple[str, Callable[[Dict], torch.Tensor]], ...]:
        """The steps of `apply` in the order it runs them, as (name, fn)
        pairs: fn takes the results of the steps before it, by name, and
        returns its own. Two device casts and the four kernel launches
        (K1, K2, K1 on the special limbs, K3)."""
        t = self._tables(level)
        b = d2.shape[0]
        l = level + 1
        n = self.ctx.n
        return (
            ("cast in", lambda r: d2.to(I32).contiguous()),
            ("K1", lambda r: intt_scale(r["cast in"], 0, l, t.q_irp_m,
                                        t.q_q32, t.q_qi32, t.q_scale_m)),
            # both accumulators as (2B, l + n_p, N)
            ("K2", lambda r: bconv_ntt_mulacc(
                r["K1"], t.w_m, t.rp_m, t.t_q32, t.t_qi32, ksk_m,
                t.alpha).reshape(2 * b, l + t.n_p, n)),
            ("K1 (C1)", lambda r: intt_scale(
                r["K2"], l, t.n_p, t.p_irp_m, t.p_q32, t.p_qi32,
                t.p_scale_m, counter=INTT_SCALE_C1)),
            ("K3", lambda r: moddown(r["K2"], r["K1 (C1)"], t.wpq_m, t.rp_m,
                                     t.t_q32, t.t_qi32, t.pinv_m)),
            ("cast out", lambda r: u32(r["K3"])),
        )

    def apply(self, d2: torch.Tensor, level: int,
              ksk_m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Key-switch d2 (B, level+1, N) int64 NTT-domain to the key in
        ksk_m (from ``ksk_mont``). Returns (e0, e1), each (B, level+1, N)
        int64, bit-identical to core/ops.key_switch per batch row."""
        b = d2.shape[0]
        record_dispatch(self.DISPATCHES_PER_APPLY)
        r: Dict[str, torch.Tensor] = {}
        for name, fn in self.steps(d2, level, ksk_m):
            r[name] = fn(r)
        out = r["cast out"]
        return out[:b], out[b:]


# ---------------------------------------------------------------------------
# staged baseline: the same pipeline as one dispatch per stage
# ---------------------------------------------------------------------------

def keyswitch_staged(ctx, d2: torch.Tensor, level: int,
                     ksk) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch-per-stage keyswitch of one row d2 (level+1, N) int64,
    NTT domain, through K4 (qhat^{-1} scale), K6 (BConv) and K5 (evk
    multiply-accumulate) plus the library NTTs; bit-identical to
    core/ops.key_switch. Records 7 dispatches per digit (iNTT, modmul,
    BConv, NTT, interleave, 2 x mulacc) plus 10 for ModDown."""
    idx_q = ctx.q_idx(level)
    idx_p = ctx.p_idx()
    target = idx_q + idx_p
    t_primes = [ctx.primes[i] for i in target]
    n = ctx.n
    acc0 = torch.zeros((len(target), n), dtype=torch.int64,
                       device=d2.device)
    acc1 = torch.zeros_like(acc0)
    ksk_sel = ksk.data[:, :, ctx.index(target)]
    pos = {g: i for i, g in enumerate(target)}
    for d, dig in enumerate(ctx.params.digit_indices(level)):
        other = [i for i in target if i not in dig]
        tabs = ctx.bconv_tables(dig, other)
        d2_dig = d2[ctx.index(dig)]
        record_dispatch()                                   # iNTT
        dig_c = ctx.intt(d2_dig, dig)
        v = kops.modmul(dig_c, tabs.qhat_inv[:, None].expand_as(dig_c),
                        [ctx.primes[i] for i in dig])
        record_dispatch()                                   # BConv
        conv = bconv_mont(v, tabs.w_mont, tabs.dst_q32, tabs.dst_qinv32)
        record_dispatch()                                   # NTT
        conv_ntt = ctx.ntt(conv, other)
        record_dispatch()                                   # interleave
        raised = torch.zeros_like(acc0)
        raised[ctx.index([pos[g] for g in dig])] = d2_dig
        raised[ctx.index([pos[g] for g in other])] = conv_ntt
        acc0 = kops.mulacc(raised, ksk_sel[d, 0], acc0, t_primes)
        acc1 = kops.mulacc(raised, ksk_sel[d, 1], acc1, t_primes)
    nq = len(idx_q)
    q = ctx.q_all[:nq][:, None]
    tabs = ctx.bconv_tables(idx_p, idx_q)
    outs = []
    for acc in (acc0, acc1):
        record_dispatch()                                   # iNTT (P)
        p_c = ctx.intt(acc[nq:], idx_p)
        v = kops.modmul(p_c, tabs.qhat_inv[:, None].expand_as(p_c),
                        [ctx.primes[i] for i in idx_p])
        record_dispatch()                                   # BConv
        conv = bconv_mont(v, tabs.w_mont, tabs.dst_q32, tabs.dst_qinv32)
        record_dispatch()                                   # NTT
        conv_ntt = ctx.ntt(conv, idx_q)
        record_dispatch()                                   # sub + P^{-1}
        diff = ma.submod(acc[:nq], conv_ntt, q)
        outs.append(ma.mulmod(diff, ctx.p_inv_mod_q[:nq][:, None], q))
    return outs[0], outs[1]
