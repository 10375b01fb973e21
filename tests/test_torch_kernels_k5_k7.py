"""Parity of the port's kernels K5-K7 and modular-reduction strategies,
on the CPU through their plain versions, with the JAX reference.

* K5 ``ops.mulacc`` against the reference's ``ops.mulacc`` (interpret
  mode) at N = 1024 and a ragged N = 1000.
* K6 ``ops.bconv``, eager and lazy, against the reference's at fig14's
  shapes (6 source primes of 28 bits, 4 destination primes of 30 bits),
  N = 256 and ragged.
* K7 ``NttKernel`` against the reference's at log_n 8 and 10, log_r
  log_n // 2 and 3; the ValueError on a block that does not divide.
* K7's column kernel as its threads compute it (``ntt.ntt_col_sched``:
  R / 16 threads a column in radix passes, 8 columns a block exchanging
  through ``ntt.col_word``) against ``ntt_col_plain`` from R = 1 to 16384,
  at a 30-bit prime and at 3221225473, and against the reference's
  four-step NTT; its exchange buffer free of bank conflicts at R = 256.
* K4, K5, K6 (both schedules) and K7 at the 32-bit prime 3221225473,
  where the reference's u32 sums wrap (fault F2): against the port's
  exact oracles (`repro_torch.kernels.ref`) and Python-int arithmetic.
* ``core/modarith``'s Barrett, Montgomery, Solinas and mulhi64 against
  the reference's at fig14's 30-bit prime.

Inputs come from numpy with fixed seeds; every comparison is exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import modarith as jma  # noqa: E402
from repro.core.params import find_2nth_root  # noqa: E402
from repro.core.params import find_ntt_primes  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import modarith as tma  # noqa: E402
from repro_torch.kernels import ntt as tntt  # noqa: E402
from repro_torch.kernels.common import sched_passes, sched_pos  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

Q32 = 3221225473            # paper_params_bootstrap's 32-bit special prime


def _rows(primes, n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, p, n) for p in primes])


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.int64))


def _j(x):
    return jnp.asarray(np.asarray(x).astype(np.uint64))


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("n", [1024, 1000])
def test_mulacc_matches_reference(n):
    primes = [m.value for m in find_ntt_primes(30, 10, 3)]
    a, b, c = (_rows(primes, n, s) for s in (1, 2, 3))
    want = _np(jops.mulacc(_j(a), _j(b), _j(c), primes, interpret=True))
    got = tops.mulacc(_t(a), _t(b), _t(c), primes)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("n", [256, 300])
def test_bconv_matches_reference(n, lazy):
    src = [m.value for m in find_ntt_primes(28, 10, 6)]
    dst = [m.value for m in find_ntt_primes(30, 10, 4)]
    v = _rows(src, n, 4)
    w = np.random.default_rng(5).integers(0, min(dst), size=(6, 4))
    want = _np(jops.bconv(_j(v), _j(w), dst, lazy=lazy, interpret=True))
    got = tops.bconv(_t(v), _t(w), dst, lazy=lazy)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("log_n,log_r", [(8, 4), (8, 3), (10, 5), (10, 3)])
def test_ntt_kernel_matches_reference(log_n, log_r):
    q = find_ntt_primes(30, log_n, 1)[0].value
    psi = find_2nth_root(q, 2 << log_n)
    a = _rows([q], 1 << log_n, log_n)[0]
    want = _np(jops.NttKernel(q, psi, log_n, log_r)(_j(a), interpret=True))
    kern = tops.NttKernel(q, psi, log_n, log_r)
    np.testing.assert_array_equal(kern(_t(a)).numpy(), want)
    # other tiles compute the same; a block that does not divide raises
    np.testing.assert_array_equal(
        kern(_t(a), block_c=4, block_r=2).numpy(), want)
    with pytest.raises(ValueError, match="must divide"):
        kern(_t(a), block_c=3)


def test_kernels_exact_at_32bit_prime():
    """K5-K7 where a residue sum passes 2^32: against the exact oracles
    and against Python ints."""
    n = 300
    primes = [Q32, 4293918721, 2013265921]
    a, b, c = (_rows(primes, n, s) for s in (6, 7, 8))
    # residues near q make every sum pass 2^32
    a[0, :8] = b[0, :8] = c[0, :8] = Q32 - 1
    q = torch.tensor(primes)
    np.testing.assert_array_equal(tops.modmul(_t(a), _t(b), primes),
                                  tref.modmul_ref(_t(a), _t(b), q))
    got = tops.mulacc(_t(a), _t(b), _t(c), primes)
    np.testing.assert_array_equal(
        got, tref.fused_mulacc_ref(_t(a), _t(b), _t(c), q))
    obj = (a.astype(object) * b.astype(object) + c.astype(object)) % \
        np.array(primes, dtype=object)[:, None]
    np.testing.assert_array_equal(got.numpy(), obj.astype(np.int64))

    src = [4293918721, 2013265921, Q32]      # sources above p_d
    dst = [Q32, 2013265921, 132120577]
    v = _rows(src, n, 9)
    w = np.random.default_rng(10).integers(0, 1 << 32, size=(3, 3))
    want = tref.bconv_ref(_t(v), _t(w % np.array(dst)), torch.tensor(dst))
    ints = (v.T.astype(object) @ w.astype(object)).T % \
        np.array(dst, dtype=object)[:, None]
    np.testing.assert_array_equal(want.numpy(), ints.astype(np.int64))
    for lazy in (False, True):
        np.testing.assert_array_equal(
            tops.bconv(_t(v), _t(w), dst, lazy=lazy), want)

    log_n = 6
    psi = find_2nth_root(Q32, 2 << log_n)
    x = _rows([Q32], 1 << log_n, 11)[0]
    kern = tops.NttKernel(Q32, psi, log_n, 3)
    got = kern(_t(x))
    np.testing.assert_array_equal(got, tref.four_step_ntt_ref(_t(x),
                                                              kern.tabs))
    naive = tref.naive_negacyclic_eval(x, Q32, psi)
    np.testing.assert_array_equal(
        got.numpy(), naive[kern.tabs.output_index_map()])


def test_modarith_strategies_match_reference():
    mod = find_ntt_primes(30, 12, 1)[0]
    q = mod.value
    rng = np.random.default_rng(12)
    a = rng.integers(0, q, size=(4, 512))
    b = rng.integers(0, q, size=(4, 512))
    ja, jb = _j(a), _j(b)
    jq = jnp.uint64(q)
    ta, tb, tq = _t(a), _t(b), torch.tensor(q)
    mu, qi, r2 = jma.barrett_mu(q), jma.mont_qinv_neg(q), jma.mont_r2(q)
    assert (mu, qi, r2) == (tma.barrett_mu(q), tma.mont_qinv_neg(q),
                            tma.mont_r2(q))
    pairs = [
        (jma.mulmod(ja, jb, jq), tma.mulmod(ta, tb, tq)),
        (jma.mulmod_barrett(ja, jb, jq, jnp.uint64(mu)),
         tma.mulmod_barrett(ta, tb, tq, torch.tensor(mu))),
        (jma.mont_mul(ja, jb, jq, jnp.uint64(qi)),
         tma.mont_mul(ta, tb, tq, torch.tensor(qi))),
        (jma.to_mont(ja, jq, jnp.uint64(qi), jnp.uint64(r2)),
         tma.to_mont(ta, tq, torch.tensor(qi), torch.tensor(r2))),
        (jma.from_mont(ja, jq, jnp.uint64(qi)),
         tma.from_mont(ta, tq, torch.tensor(qi))),
        (jma.mulmod_solinas(ja, jb, jq, *mod.solinas),
         tma.mulmod_solinas(ta, tb, tq, *mod.solinas)),
        (jma.solinas_reduce(ja * jb, jq, *mod.solinas),
         tma.solinas_reduce(ta * tb, tq, *mod.solinas)),
    ]
    for want, got in pairs:
        np.testing.assert_array_equal(got.numpy(), _np(want))
    x = rng.integers(0, 1 << 62, size=256)
    y = rng.integers(0, 1 << 62, size=256)
    np.testing.assert_array_equal(
        tma.mulhi64(_t(x), _t(y)).numpy(),
        _np(jma.mulhi64(_j(x), _j(y))))


@pytest.mark.parametrize("q", [None, Q32])
@pytest.mark.parametrize("log_n,log_r", [
    (10, 0), (8, 3), (8, 4), (10, 5), (12, 6), (10, 8), (16, 8), (12, 9),
    (14, 11), (15, 12), (16, 14)])
def test_ntt_col_schedule_equals_plain(log_n, log_r, q):
    """Column-kernel shapes of every kind the C entry instantiates: one
    thread a column (R <= 16), one exchange (R = 32 to 256), two (R = 512
    to 4096), three (R = 8192, 16384), fewer than 8 columns a block
    because C is small (R = 256, C = 4) or R is large (R = 4096: 4
    columns of 256 threads; R = 16384: 1 column of 1024)."""
    q = q or find_ntt_primes(30, log_n, 1)[0].value
    psi = find_2nth_root(q, 2 << log_n)
    kern = tops.NttKernel(q, psi, log_n, log_r)
    kt = kern.tables("cpu")
    a = _t(_rows([q], 1 << log_n, log_n + log_r)[0])
    got = tntt.ntt_col_sched(a, kt)
    assert torch.equal(got, tntt.ntt_col_plain(a, kt))
    if q != Q32 and log_n <= 10 and log_r:   # the reference needs R > 1
        want = _np(jops.NttKernel(q, psi, log_n, log_r)(_j(a.numpy()),
                                                        interpret=True))
        np.testing.assert_array_equal(
            tntt.ntt_row_plain(got, kt).numpy(), want)


@pytest.mark.parametrize("log_c", [0, 2, 3, 8])
def test_ntt_col_block_fits_a_block(log_c):
    """For every R the C entry takes, `col_block` divides C, takes 8
    columns where C and R allow it, and keeps a block within 1024
    threads and the shared memory a block may use."""
    c = 1 << log_c
    for log_r in range(tntt.MAX_COL_LOG_R + 1):
        r = 1 << log_r
        bc = tntt.col_block(log_r, c)
        threads = bc * max(1, r // 16)
        assert c % bc == 0 and threads <= tntt.MAX_THREADS, (log_r, bc)
        assert 4 * bc * (r + r // 16) <= tntt.SMEM_BYTES, (log_r, bc)
        assert bc == min(8, c, 16384 // r), (log_r, bc)


def test_ntt_col_exchange_without_bank_conflicts_at_r256():
    """At R = C = 256 a block's 128 threads (thread t: column t % 8,
    column thread t // 8) store the first pass's rows and load the second
    pass's through `col_word`: every word of the buffer once, and no
    access of a warp hits a bank twice."""
    log_r, bc = 8, tntt.COL_BLOCK
    t = torch.arange(bc << (log_r - 4))
    col, tid = t % bc, t // bc
    j = torch.arange(16)[None, :]
    for st, lr in sched_passes(log_r):
        pos, _ = sched_pos(log_r, st, lr, tid[:, None], j)
        words = tntt.col_word(pos, col[:, None], bc)
        assert len(set(words.flatten().tolist())) == (bc << log_r)
        assert int(words.max()) < (256 + 16) * bc
        for v in range(16):
            for warp in (words[:, v] % 32).reshape(-1, 32):
                assert len(set(warp.tolist())) == 32, (st, v)
