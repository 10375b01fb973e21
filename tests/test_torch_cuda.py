"""The port's CUDA kernels against their plain versions, on a CUDA card.

Every test carries the ``cuda`` marker and skips (inside the fixture)
where there is no CUDA device, as on a CPU-only runner; there
chip_smoke.py is what holds the kernels to their plain versions. Run on
the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Covers every chunking of the NTT kernels (N = 2^10: one chunk in shared
memory; 2^15: a cluster of two; 2^16: of four), K1 at both launch shapes
of the serve path (paper parameters, level 20, B = 8) and its launch
shape, K2 and K3 at batch 8 with the 32-bit prime among the special
primes, ragged tail digits, a ragged K4 row length, and one launch count
per wrapper call; K5 (mulacc), K6 (bconv, eager and lazy) and K7
(ntt_col + ntt_row) at ragged N, at the 32-bit prime 3221225473, with
K7's block-divisibility error; K6 at every S of its cases (1, 3, 6 and
the largest instantiated) against D = 4, 21, 24, 27 and N = 65536,
65500, 1024, 777, 100, an 8-byte aligned source, its launch against
``bconv_sched`` and its ValueError above the largest S; ntt_col at
R = 16 to 16384 (every kind of its kernel) with every block_c the
reference accepts and its launch; ntt_row at C = 1 to 16384 (every kind
of its kernel) with every block_r the reference accepts, its launch
(the tiling ``ntt_row_sched`` models), its ValueError above C = 16384
and its C entry's refusal of a tiling past the launch bound; and the
staged keyswitch against the library route.
Imports nothing of JAX, so it runs where only torch is installed.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import modarith as ma  # noqa: E402
from repro_torch.core import ops as hops  # noqa: E402
from repro_torch.core.context import CkksContext  # noqa: E402
from repro_torch.core.encryptor import CkksEncryptor  # noqa: E402
from repro_torch.core.params import CkksParams  # noqa: E402
from repro_torch.core.params import find_2nth_root  # noqa: E402
from repro_torch.core.params import find_ntt_primes  # noqa: E402
from repro_torch.core.params import paper_params_bootstrap  # noqa: E402
from repro_torch.kernels import bconv as bc  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels import keyswitch as ks  # noqa: E402
from repro_torch.kernels import modmul as mm  # noqa: E402
from repro_torch.kernels import ntt as kntt  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402

Q32 = 3221225473            # the 32-bit special prime of paper parameters

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _stack(log_n, device):
    # special_mod_bits=31 lets the prime search return a 32-bit prime
    params = CkksParams(log_n=log_n, log_scale=28, n_levels=5, dnum=2,
                        first_mod_bits=31, scale_mod_bits=28,
                        special_mod_bits=31)
    ctx = CkksContext(params, device)
    enc = CkksEncryptor(ctx, seed=3)
    rk = enc.relin_keygen(enc.keygen())
    return ctx, rk


def _d2(ctx, batch, level, seed):
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, ctx.primes[j], size=(batch, ctx.n))
            for j in range(level + 1)]
    return torch.from_numpy(np.stack(cols, 1)).to(ctx.device)


@pytest.mark.parametrize("log_n", [10, 15, 16])
def test_kernels_equal_plain_and_library(cuda, log_n):
    ctx, rk = _stack(log_n, cuda)
    fks = ks.FusedKeySwitch(ctx)
    for level in (5, 3):                    # digits 3+3, and 3+1 (ragged)
        t = fks._tables(level)
        l = level + 1
        km = fks.ksk_mont("relin", level, rk.data)
        d2 = _d2(ctx, 3, level, seed=level)
        a1 = (d2.to(torch.int32), 0, l, t.q_irp_m, t.q_q32, t.q_qi32,
              t.q_scale_m)
        v = ks.intt_scale(*a1)
        assert torch.equal(v, ks.intt_scale_plain(*a1))
        a2 = (v, t.w_m, t.rp_m, t.t_q32, t.t_qi32, km, t.alpha)
        acc = ks.bconv_ntt_mulacc(*a2)
        assert torch.equal(acc, ks.bconv_ntt_mulacc_plain(*a2))
        g = acc.reshape(6, l + t.n_p, ctx.n)
        a1c = (g, l, t.n_p, t.p_irp_m, t.p_q32, t.p_qi32, t.p_scale_m)
        vp = ks.intt_scale(*a1c)
        assert torch.equal(vp, ks.intt_scale_plain(*a1c))
        a3 = (g, vp, t.wpq_m, t.rp_m, t.t_q32, t.t_qi32, t.pinv_m)
        assert torch.equal(ks.moddown(*a3), ks.moddown_plain(*a3))
        e0, e1 = fks.apply(d2, level, km)
        r0, r1 = hops.key_switch(ctx, d2, level, rk)
        assert torch.equal(e0, r0) and torch.equal(e1, r1)


@pytest.mark.parametrize("log_n", [10, 16])
def test_fused_rescale_equal_library(cuda, log_n):
    """The kernel route's rescale (K1 on the last limb, K3 with it as a
    one-limb basis) against core/ops.rescale at every level, batch 3;
    one launch each of K1 and K3 a call, on the rescale's own counters."""
    from repro_torch.core.ciphertext import Ciphertext
    ctx, _ = _stack(log_n, cuda)
    fks = ks.FusedKeySwitch(ctx)
    for level in range(1, ctx.n_q):
        data = torch.stack([_d2(ctx, 3, level, seed=level + k)
                            for k in range(2)], 1)
        common.reset_launches()
        got = fks.rescale(data, level)
        assert ks.INTT_SCALE_RESCALE.launches == 1
        assert ks.MODDOWN_RESCALE.launches == 1
        assert ks.INTT_SCALE_C1.launches == ks.MODDOWN.launches == 0
        want = hops.rescale(ctx, Ciphertext(data, level, 2.0 ** 28))
        assert torch.equal(got, want.data)


def test_cluster_kernels_full_batch_32bit_special_prime(cuda):
    """K2 and K3 at logN = 16 (clusters of 4 chunks of 16384), B = 8,
    two digits of 6 (level 11) and a ragged tail (level 8), with the
    32-bit prime among the special primes of the key; then the whole
    fused keyswitch against the library route."""
    params = CkksParams(log_n=16, log_scale=28, n_levels=11, dnum=2,
                        first_mod_bits=31, scale_mod_bits=28,
                        special_mod_bits=31)
    ctx = CkksContext(params, cuda)
    assert Q32 in ctx.p_primes
    rk = CkksEncryptor(ctx, seed=5).relin_keygen(
        CkksEncryptor(ctx, seed=5).keygen())
    fks = ks.FusedKeySwitch(ctx)
    for level in (11, 8):
        t = fks._tables(level)
        l, t_n = level + 1, level + 1 + t.n_p
        km = fks.ksk_mont("relin", level, rk.data)
        d2 = _d2(ctx, 8, level, seed=level)
        v = ks.intt_scale(d2.to(torch.int32), 0, l, t.q_irp_m, t.q_q32,
                          t.q_qi32, t.q_scale_m)
        a2 = (v, t.w_m, t.rp_m, t.t_q32, t.t_qi32, km, t.alpha)
        before = (ks.BCONV_NTT_MULACC.launches, ks.MODDOWN.launches)
        acc = ks.bconv_ntt_mulacc(*a2)
        assert torch.equal(acc, ks.bconv_ntt_mulacc_plain(*a2))
        g = acc.reshape(16, t_n, ctx.n)
        vp = ks.intt_scale(g, l, t.n_p, t.p_irp_m, t.p_q32, t.p_qi32,
                           t.p_scale_m)
        a3 = (g, vp, t.wpq_m, t.rp_m, t.t_q32, t.t_qi32, t.pinv_m)
        assert torch.equal(ks.moddown(*a3), ks.moddown_plain(*a3))
        assert (ks.BCONV_NTT_MULACC.launches, ks.MODDOWN.launches) == (
            before[0] + 1, before[1] + 1)
        e0, e1 = fks.apply(d2, level, km)
        r0, r1 = hops.key_switch(ctx, d2, level, rk)
        assert torch.equal(e0, r0) and torch.equal(e1, r1)
    for name, dims in (("bconv_ntt_mulacc", (8, l, t_n, t.n_digits,
                                             t.alpha)),
                       ("moddown", (16, l, t_n, t.n_p))):
        info = ks.launch_info(name, ctx.n, *dims)
        assert info["cluster"] == 4 and info["threads"] == 1024, info
        assert info["max_active_clusters"] > 0, info


def _residues(primes, lead, n, seed, device):
    """Random residues (lead..., len(primes), n) int32, row i below
    primes[i]."""
    rng = np.random.default_rng(seed)
    rows = [rng.integers(0, p, size=(*lead, n)) for p in primes]
    return torch.from_numpy(np.stack(rows, len(lead)).astype(
        np.uint32).view(np.int32)).to(device)


@pytest.mark.parametrize("log_n", [10, 15, 16])
def test_intt_scale_both_launch_shapes(cuda, log_n):
    """K1 at the two launches of a keyswitch at B = 8: stage A over every
    Q limb (row0 = 0) and C1 over the special limbs of both accumulators
    (row0 = l), each counted on its own counter; at logN = 16 with the
    paper parameters' level 20 (3221225473 among the special primes)."""
    if log_n == 16:
        ctx, level = CkksContext(paper_params_bootstrap(), cuda), 20
        assert Q32 in ctx.p_primes
    else:
        ctx, level = _stack(log_n, cuda)[0], 5
    t = ks.FusedKeySwitch(ctx)._tables(level)
    l, n_p = level + 1, t.n_p
    q_primes = ctx.primes[:l]
    p_primes = ctx.p_primes
    d2 = _residues(q_primes, (8,), ctx.n, log_n, cuda)
    g = _residues(q_primes + list(p_primes), (16,), ctx.n, log_n + 1, cuda)
    before = (ks.INTT_SCALE.launches, ks.INTT_SCALE_C1.launches)
    a1 = (d2, 0, l, t.q_irp_m, t.q_q32, t.q_qi32, t.q_scale_m)
    assert torch.equal(ks.intt_scale(*a1), ks.intt_scale_plain(*a1))
    a1c = (g, l, n_p, t.p_irp_m, t.p_q32, t.p_qi32, t.p_scale_m)
    assert torch.equal(ks.intt_scale(*a1c, counter=ks.INTT_SCALE_C1),
                       ks.intt_scale_plain(*a1c))
    assert (ks.INTT_SCALE.launches, ks.INTT_SCALE_C1.launches) == (
        before[0] + 1, before[1] + 1)
    nch = {10: 1, 15: 2, 16: 4}[log_n]
    for dims in ((8, l, l), (16, l + n_p, n_p)):
        info = ks.launch_info("intt_scale", ctx.n, *dims)
        assert (info["grid_x"], info["grid_y"], info["grid_z"]) == (
            nch, dims[2], dims[0]), info
        assert info["cluster"] == nch, info
        assert info["threads"] == ctx.n // nch // 16, info
        assert info["local_bytes"] <= 16, info
        assert info["max_active_clusters"] > 0, info


@pytest.mark.parametrize("q", [None, Q32])
@pytest.mark.parametrize("log_n,log_r", [
    (8, 4), (10, 5), (12, 6), (16, 8), (12, 9), (14, 11), (15, 12),
    (16, 14)])
def test_ntt_col_equal_plain(cuda, q, log_n, log_r):
    """Every kind of column kernel: R = 16 (one thread a column), 32, 64
    and 256 (one exchange), 512 and 2048 (two; 69632 B of shared memory
    at R = 2048), 4096 (4 columns a block) and 16384 (three exchanges,
    one column of 1024 threads a block), with every block_c the
    reference accepts (it must divide C; the kernel's tiling does not
    depend on it), and the launch the library reports for it."""
    q = q or find_ntt_primes(30, log_n, 1)[0].value
    kern = kops.NttKernel(q, find_2nth_root(q, 2 << log_n), log_n, log_r)
    kt = kern.tables(cuda)
    c = 1 << (log_n - log_r)
    a = torch.from_numpy(np.random.default_rng(log_r).integers(
        0, q, 1 << log_n)).to(cuda)
    want = kntt.ntt_col_plain(a, kt)
    for block_c in (1, 8, c, 128):
        before = kntt.NTT_COL.launches
        assert torch.equal(kntt.ntt_col(a, kt, block_c), want), block_c
        assert kntt.NTT_COL.launches == before + 1
    with pytest.raises(ValueError, match="must divide"):
        kntt.ntt_col(a, kt, 3)
    info = kntt.launch_info(log_r, c)
    bc = kntt.col_block(log_r, c)
    assert (info["grid_x"], info["grid_y"], info["cluster"]) == (
        c // bc, 1, 1), info
    assert info["threads"] == bc * max(1, (1 << log_r) // 16), info
    assert info["local_bytes"] <= 16 and info["max_active_clusters"] > 0


@pytest.mark.parametrize("q", [None, Q32])
@pytest.mark.parametrize("log_n,log_c", [
    (6, 0), (8, 4), (10, 5), (12, 6), (16, 8), (12, 9), (16, 10),
    (14, 12), (16, 13), (16, 14)])
def test_ntt_row_equal_plain(cuda, q, log_n, log_c):
    """Every kind of row kernel: C = 1 and 16 (one thread a row), 32, 64
    and 256 (one exchange), 512 (two, the row within one warp), 1024 and
    4096 (two, a block barrier), 8192 and 16384 (three; one row of 1024
    threads a block), with every block_r the reference accepts (it must
    divide R; the kernel's tiling does not depend on it), and the launch
    the library reports for it, against the tiling `ntt_row_sched`
    models."""
    q = q or find_ntt_primes(30, log_n, 1)[0].value
    log_r = log_n - log_c
    kern = kops.NttKernel(q, find_2nth_root(q, 2 << log_n), log_n, log_r)
    kt = kern.tables(cuda)
    r, c = 1 << log_r, 1 << log_c
    y = torch.from_numpy(np.random.default_rng(log_c).integers(
        0, q, (r, c))).to(torch.int32).to(cuda)
    want = kntt.ntt_row_plain(y, kt)
    for block_r in (1 << k for k in range(log_r + 1)):
        before = kntt.NTT_ROW.launches
        assert torch.equal(kntt.ntt_row(y, kt, block_r), want), block_r
        assert kntt.NTT_ROW.launches == before + 1
    if r > 2:
        with pytest.raises(ValueError, match="must divide"):
            kntt.ntt_row(y, kt, 3)
    rows = kntt.row_block(log_c, r)
    info = kntt.row_launch_info(log_c, r)
    assert (info["grid_x"], info["grid_y"], info["cluster"]) == (
        r // rows, 1, 1), info
    assert info["threads"] == rows * kntt.row_threads(log_c), info
    words = kntt.row_words(c) if log_c > 4 else 0
    assert info["smem_bytes"] == 4 * rows * words, info
    assert info["local_bytes"] <= 16, info
    assert info["max_active_clusters"] > 0, info


def test_ntt_row_refuses_rows_above_16384(cuda):
    """C = 32768 (R = 2 at N = 2^16) would take 2048 threads a row: a
    ValueError before any launch, on the call and on the read-out."""
    q = find_ntt_primes(30, 16, 1)[0].value
    kern = kops.NttKernel(q, find_2nth_root(q, 2 << 16), 16, 1)
    kt = kern.tables(cuda)
    y = torch.zeros((2, 1 << 15), dtype=torch.int32, device=cuda)
    before = kntt.NTT_ROW.launches
    with pytest.raises(ValueError, match="C <= 16384"):
        kntt.ntt_row(y, kt, 1)
    with pytest.raises(ValueError, match="C <= 16384"):
        kntt.row_launch_info(15, 2)
    assert kntt.NTT_ROW.launches == before


def test_ntt_row_refuses_tiling_past_its_bound(cuda):
    """The C entry refuses a tiling past the kernel's launch bound: at C =
    256 a block holds at most 64 threads (4 rows), so 8 rows, or rows that
    do not divide R, return an error and launch nothing."""
    for rows in (8, 3, 0):
        with pytest.raises(RuntimeError, match="CUDA error"):
            build.launch_info("ntt.cu", "rt_ntt_row_info", 256, 8, rows)
    assert build.launch_info("ntt.cu", "rt_ntt_row_info", 256, 8, 4)[
        "threads"] == 64


def test_modmul_ragged_and_counted(cuda):
    primes = [2013265921, 3221225473, 132120577]
    rng = np.random.default_rng(0)
    n = 700
    a = torch.from_numpy(np.stack([rng.integers(0, p, n)
                                   for p in primes * 4])).to(cuda)
    b = torch.from_numpy(np.stack([rng.integers(0, p, n)
                                   for p in primes])).to(cuda)
    before = mm.MODMUL.launches
    out = kops.modmul(a, b, primes)
    assert mm.MODMUL.launches == before + 1
    q = torch.tensor(primes, device=cuda)[:, None]
    ref = ((a.view(4, 3, n).cpu().numpy().astype(object)
            * b.cpu().numpy().astype(object))
           % q.cpu().numpy().astype(object)).reshape(12, n)
    np.testing.assert_array_equal(out.cpu().numpy(), ref.astype(np.int64))
    assert common.KERNELS["modmul"] is mm.MODMUL


def _rows(primes, n, rng, device, reps=1):
    return torch.from_numpy(np.stack([rng.integers(0, p, n)
                                      for p in primes * reps])).to(device)


@pytest.mark.parametrize("n", [65536, 1000])
def test_mulacc_equal_plain_and_oracle(cuda, n):
    primes = [2013265921, Q32, 132120577]
    rng = np.random.default_rng(n)
    a, c = (_rows(primes, n, rng, cuda, 2) for _ in range(2))
    b = _rows(primes, n, rng, cuda)
    q64, q32, qi, rm = kops._mont_consts(tuple(primes), str(cuda))
    b_mont = ma.mulmod(b, rm[:, None], q64[:, None]).to(torch.int32)
    before = mm.MULACC.launches
    out = mm.mulacc_mont(a, b_mont, c, q32, qi)
    assert mm.MULACC.launches == before + 1
    assert torch.equal(out, mm.mulacc_mont_plain(a, b_mont, c, q32, qi))
    want = kref.fused_mulacc_ref(a, b.repeat(2, 1), c, q64.repeat(2))
    assert torch.equal(out, want)
    assert torch.equal(kops.mulacc(a, b, c, primes), want)


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("n", [65536, 777])
def test_bconv_equal_plain_and_oracle(cuda, lazy, n):
    """Sources above the destinations (as in ModDown) and the 32-bit
    prime among the destinations (as in the staged ModUp)."""
    src = [Q32, 4293918721, 2013265921, 2113929217, 2130706433, 2146959361]
    dst = [m.value for m in find_ntt_primes(30, 10, 20)] + [Q32]
    rng = np.random.default_rng(n + lazy)
    v = _rows(src, n, rng, cuda)
    w = torch.from_numpy(np.stack([rng.integers(0, 1 << 32, len(dst))
                                   for _ in src])).to(cuda)
    p64, p32, pinv, rm = kops._mont_consts(tuple(dst), str(cuda))
    w_mont = ma.mulmod(w.T % p64[:, None], rm[:, None],
                       p64[:, None]).to(torch.int32).contiguous()
    counter = bc.BCONV_LAZY if lazy else bc.BCONV
    before = counter.launches
    out = bc.bconv_mont(v, w_mont, p32, pinv, lazy=lazy)
    assert counter.launches == before + 1
    assert torch.equal(out, bc.bconv_plain(v, w_mont, p32, pinv, lazy))
    want = kref.bconv_ref(v, w % p64, p64)
    assert torch.equal(out, want)
    assert torch.equal(kops.bconv(v, w, dst, lazy=not lazy), want)


# K6's sources above its destinations, the 32-bit prime first
BCONV_SRC = [Q32, 4293918721, 2013265921, 2113929217, 2130706433,
             2146959361, 4293230593]


@functools.lru_cache(maxsize=None)
def _bconv_dst(d):
    """d destination primes: d - 2 of 30 bits, then two above 2^31 (the
    kernel's other arithmetic path), the 32-bit special prime last."""
    return tuple(m.value for m in find_ntt_primes(30, 10, d - 2)) + (
        4293918721, Q32)


@pytest.mark.parametrize("n", [65536, 65500, 1024, 777, 100])
@pytest.mark.parametrize("d", [4, 21, 24, 27])
@pytest.mark.parametrize("s", [1, 3, 6, bc.MAX_S])
def test_bconv_shapes_equal_plain_and_oracle(cuda, s, d, n):
    src, dst = BCONV_SRC[:s], list(_bconv_dst(d))
    rng = np.random.default_rng(1000 * s + d + n)
    v = _rows(src, n, rng, cuda)
    w = torch.from_numpy(np.stack([rng.integers(0, 1 << 32, d)
                                   for _ in src])).to(cuda)
    p64, p32, pinv, rm = kops._mont_consts(tuple(dst), str(cuda))
    w_mont = ma.mulmod(w.T % p64[:, None], rm[:, None],
                       p64[:, None]).to(torch.int32).contiguous()
    want = kref.bconv_ref(v, w % p64, p64)
    # the same rows 8 bytes past a 16-byte boundary: the 8-byte path
    shifted = torch.empty(s * n + 1, dtype=torch.int64, device=cuda)
    v8 = shifted[1:].view(s, n)
    v8.copy_(v)
    for lazy, counter in ((False, bc.BCONV), (True, bc.BCONV_LAZY)):
        before = counter.launches
        out = bc.bconv_mont(v, w_mont, p32, pinv, lazy=lazy)
        assert counter.launches == before + 1
        assert torch.equal(out, bc.bconv_plain(v, w_mont, p32, pinv, lazy))
        assert torch.equal(out, want)
        assert torch.equal(bc.bconv_mont(v8, w_mont, p32, pinv, lazy=lazy),
                           want)
        assert counter.launches == before + 2


@pytest.mark.parametrize("s,d,n", [(6, 21, 65536), (3, 24, 65536),
                                   (6, 4, 1024), (7, 27, 777), (1, 4, 100)])
def test_bconv_launch_matches_sched(cuda, s, d, n):
    sch = bc.bconv_sched(s, d, n)
    for lazy in (False, True):
        info = bc.launch_info(s, d, n, lazy)
        assert (info["grid_x"], info["grid_y"], info["grid_z"]) == (
            *sch.grid, 1)
        assert (info["threads"], info["cluster"]) == (sch.threads, 1)
        assert info["smem_bytes"] == 4 * bc.GROUP * (s + 2)
        assert info["local_bytes"] == 0


def test_bconv_refuses_s_above_instances(cuda):
    s, d = bc.MAX_S + 1, 4
    z = torch.zeros((d, s), dtype=torch.int32, device=cuda)
    p = torch.full((d,), 5, dtype=torch.int32, device=cuda)
    before = bc.BCONV.launches
    with pytest.raises(ValueError, match="instantiated"):
        bc.bconv_mont(torch.zeros((s, 64), dtype=torch.int64, device=cuda),
                      z, p, p)
    with pytest.raises(ValueError, match="instantiated"):
        bc.launch_info(s, d, 64)
    assert bc.BCONV.launches == before


@pytest.mark.parametrize("q,log_n,log_r", [
    (None, 16, 8), (Q32, 16, 8), (None, 12, 6), (Q32, 10, 3)])
def test_ntt_four_step_equal_plain_and_oracle(cuda, q, log_n, log_r):
    q = q or find_ntt_primes(30, log_n, 1)[0].value
    kern = kops.NttKernel(q, find_2nth_root(q, 2 << log_n), log_n, log_r)
    kt = kern.tables(cuda)
    a = torch.from_numpy(np.random.default_rng(log_n).integers(
        0, q, 1 << log_n)).to(cuda)
    before = (kntt.NTT_COL.launches, kntt.NTT_ROW.launches)
    y = kntt.ntt_col(a, kt, 128)
    assert torch.equal(y, kntt.ntt_col_plain(a, kt))
    out = kntt.ntt_row(y, kt, 8)
    assert torch.equal(out, kntt.ntt_row_plain(y, kt))
    assert (kntt.NTT_COL.launches, kntt.NTT_ROW.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(out, kref.four_step_ntt_ref(a, kern.tabs))
    for blocks in ({"block_c": 16, "block_r": 1}, {}):
        assert torch.equal(kern(a, **blocks), out)
    with pytest.raises(ValueError, match="must divide"):
        kern(a, block_c=3)


def test_staged_keyswitch_equal_library(cuda):
    ctx, rk = _stack(10, cuda)
    level = 5
    d2 = _d2(ctx, 1, level, seed=1)[0]
    before = {k: common.KERNELS[k].launches
              for k in ("modmul", "mulacc", "bconv")}
    common.reset_dispatch_count()
    s0, s1 = ks.keyswitch_staged(ctx, d2, level, rk)
    digits = len(ctx.params.digit_indices(level))
    assert common.dispatch_count() == 7 * digits + 10
    r0, r1 = hops.key_switch(ctx, d2, level, rk)
    assert torch.equal(s0, r0) and torch.equal(s1, r1)
    grew = {k: common.KERNELS[k].launches - v for k, v in before.items()}
    assert grew == {"modmul": digits + 2, "mulacc": 2 * digits,
                    "bconv": digits + 2}
