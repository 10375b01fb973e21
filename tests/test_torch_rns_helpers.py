"""The port's core helpers that have no use on the serve path, held to
the JAX reference: `rns.bconv_matmul` (with the carry the reference's u64
sum lacks at the 32-bit prime), `rns.exact_div_by_last_coeff`,
`ntt.negacyclic_convolve_ref` (the host schoolbook oracle),
`modarith.powmod_scalar` and `modarith.to_i64` (the counterpart of the
reference's `to_u64`). Mirrors tests/test_ckks_e2e.py's BConv test and
tests/test_ntt.py's convolution and monomial tests."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.core import modarith as j_ma  # noqa: E402
from repro.core import ntt as j_ntt  # noqa: E402
from repro.core import rns as j_rns  # noqa: E402
from repro.core.context import CkksContext as JCtx  # noqa: E402
from repro.core.params import find_ntt_primes as j_find  # noqa: E402
from repro.core.params import test_params as j_test_params  # noqa: E402

from repro_torch.core import modarith as ma  # noqa: E402
from repro_torch.core import ntt as nttm  # noqa: E402
from repro_torch.core import rns  # noqa: E402
from repro_torch.core.context import CkksContext  # noqa: E402
from repro_torch.core.params import (  # noqa: E402
    find_ntt_primes, generic_ntt_primes)
from repro_torch.core.params import (  # noqa: E402
    test_params as t_test_params)

CPU = torch.device("cpu")
# paper_params_bootstrap's special prime and the largest NTT prime below
# 2^32; both are ≡ 1 mod 2^21
Q32 = (3221225473, 4293918721)


@pytest.fixture(scope="module")
def ctxs():
    """conftest's ckks_small parameters in both packages."""
    kw = dict(log_n=8, n_levels=4, dnum=2, log_scale=26)
    jctx, tctx = JCtx(j_test_params(**kw)), CkksContext(t_test_params(**kw),
                                                        CPU)
    assert jctx.primes == tctx.primes
    return jctx, tctx


def test_bconv_matmul_matches_reference(ctxs):
    """tests/test_ckks_e2e.py::test_bconv_exact_vs_bigint's inputs: the
    port's bconv_matmul equals the reference's bconv_matmul and bconv,
    and the fast conversion's slack is a small multiple of Q."""
    jctx, ctx = ctxs
    rng = np.random.default_rng(1234)
    src, dst = ctx.q_idx(2), ctx.p_idx()
    src_primes = [ctx.primes[i] for i in src]
    big_q = int(np.prod([int(p) for p in src_primes], dtype=object))
    x = rns.crt_lift_centered(
        np.stack([rng.integers(0, p, size=64, dtype=np.uint64)
                  for p in src_primes]), src_primes)
    limbs = np.stack([(x % p).astype(np.uint64) for p in src_primes])
    jt = jctx.bconv_tables(src, dst)
    want = np.asarray(j_rns.bconv_matmul(jnp.asarray(limbs), jt))
    np.testing.assert_array_equal(
        want, np.asarray(j_rns.bconv(jnp.asarray(limbs), jt)))
    got = rns.bconv_matmul(ma.to_i64(limbs), ctx.bconv_tables(src, dst))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    for i, p in enumerate(ctx.primes[j] for j in dst):
        diff = (got[i].numpy().astype(object) - (x % p)) % p
        allowed = {(k * big_q) % p for k in range(len(src_primes) + 1)}
        assert set(int(d) for d in diff) <= allowed


@pytest.mark.parametrize("batch", [(), (3,)])
def test_bconv_matmul_at_32bit_primes(batch):
    """3221225473 and 4293918721 among the sources, and 32-bit
    destinations: products pass 2^63 and a fold's sum of 4 passes 2^64,
    past the reference's u64 sum (F2). The port's lazy sum keeps its
    carry and equals its own rns.bconv and the reference's bconv (each of
    whose terms is reduced before the sum)."""
    log_n = 6
    # paper_params_bootstrap's draw at this ring: six 31-bit primes, then
    # 3221225473 and 4293918721
    src = list(Q32) + [m.value for m in find_ntt_primes(31, log_n, 3)]
    dst = generic_ntt_primes(32, 1 << (log_n + 1), 3, exclude=Q32)
    rng = np.random.default_rng(7)
    v = np.stack([rng.integers(0, p, size=batch + (1 << log_n,),
                               dtype=np.uint64) for p in src], axis=-2)
    t = rns.make_bconv_tables(src, dst, CPU)
    got = rns.bconv_matmul(ma.to_i64(v), t)
    assert torch.equal(got, rns.bconv(ma.to_i64(v), t))
    jt = j_rns.make_bconv_tables(src, dst)
    want = np.asarray(j_rns.bconv(jnp.asarray(v), jt))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # the first fold's exact sum passes 2^64 somewhere, and there the
    # reference's own lazy sum wraps
    vs = ma.mulmod(ma.to_i64(v), t.qhat_inv[:, None], t.src_q[:, None])
    first = sum(vs[..., j, :].numpy().astype(object) * int(t.w[j, 0])
                for j in range(4))
    assert max(first.ravel()) >= 2 ** 64
    assert not np.array_equal(
        np.asarray(j_rns.bconv_matmul(jnp.asarray(v), jt)), want)


def test_exact_div_by_last_coeff(ctxs):
    jctx, ctx = ctxs
    rng = np.random.default_rng(3)
    lvl = 4
    q = ctx.q_primes[:lvl]
    a = np.stack([rng.integers(0, p, size=(2, ctx.n), dtype=np.uint64)
                  for p in q], axis=-2)
    q_last_inv = [pow(ctx.q_primes[lvl], -1, p) for p in q]
    want = np.asarray(j_rns.exact_div_by_last_coeff(
        jnp.asarray(a), jnp.asarray(np.array(q_last_inv, np.uint64)),
        jnp.asarray(np.array(q, np.uint64))))
    got = rns.exact_div_by_last_coeff(ma.to_i64(a), ctx.qlast_inv(lvl),
                                      ctx.q_all[:lvl])
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("log_n", [6, 8])
def test_negacyclic_convolution(log_n):
    """tests/test_ntt.py::test_negacyclic_convolution: the NTT product
    equals the schoolbook oracle, which equals the reference's."""
    primes = find_ntt_primes(30, log_n, 3)
    assert [m.value for m in primes] == [m.value for m in
                                         j_find(30, log_n, 3)]
    tabs = nttm.NttTables(primes, log_n, CPU)
    rng = np.random.default_rng(99)
    q = tabs.q.numpy()
    a = rng.integers(0, 2 ** 62, size=(3, tabs.n), dtype=np.uint64) % \
        q[:, None].astype(np.uint64)
    b = rng.integers(0, 2 ** 62, size=(3, tabs.n), dtype=np.uint64) % \
        q[:, None].astype(np.uint64)
    fa, fb = nttm.ntt(ma.to_i64(a), tabs), nttm.ntt(ma.to_i64(b), tabs)
    conv = nttm.intt(ma.mulmod(fa, fb, tabs.q[:, None]), tabs).numpy()
    for limb in range(3):
        p = int(q[limb])
        ref = nttm.negacyclic_convolve_ref(a[limb], b[limb], p)
        assert ref.dtype == np.int64
        np.testing.assert_array_equal(conv[limb], ref)
        np.testing.assert_array_equal(
            ref, j_ntt.negacyclic_convolve_ref(a[limb], b[limb], p).astype(
                np.int64))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_monomial_product(seed):
    """tests/test_ntt.py::test_ntt_parseval_like_property: multiplying by
    X^i through the NTT equals the oracle's negacyclic shift."""
    log_n = 6
    tabs = nttm.NttTables(find_ntt_primes(30, log_n, 1), log_n, CPU)
    n, p = tabs.n, int(tabs.q[0])
    rng = np.random.default_rng(seed)
    i = int(rng.integers(0, n))
    a = rng.integers(0, p, size=(1, n), dtype=np.uint64)
    mono = np.zeros((1, n), dtype=np.uint64)
    mono[0, i] = 1
    fa, fm = nttm.ntt(ma.to_i64(a), tabs), nttm.ntt(ma.to_i64(mono), tabs)
    prod = nttm.intt(ma.mulmod(fa, fm, tabs.q[:, None]), tabs)
    ref = nttm.negacyclic_convolve_ref(a[0], mono[0], p)
    np.testing.assert_array_equal(prod[0].numpy(), ref)
    np.testing.assert_array_equal(
        ref, j_ntt.negacyclic_convolve_ref(a[0], mono[0], p).astype(np.int64))


@pytest.mark.parametrize("a,e,q", [(3, 10, 97), (2, 2 ** 40 + 1, Q32[0]),
                                   (Q32[1] - 1, 3, Q32[1]), (-5, 7, 65537),
                                   (np.uint64(12345), np.int64(6), Q32[0])])
def test_powmod_scalar(a, e, q):
    got = ma.powmod_scalar(a, e, q)
    assert type(got) is int and got == j_ma.powmod_scalar(a, e, q)


def test_to_i64():
    """The reference's to_u64 values as an int64 tensor, from numpy of any
    integer dtype, python ints and tensors; 2^63 and above refused."""
    vals = [0, 1, 2 ** 31, Q32[0] - 1, 2 ** 32 - 1, 2 ** 62]
    want = np.asarray(j_ma.to_u64(np.array(vals, np.uint64)))
    for x in (np.array(vals, np.uint64), np.array(vals, np.int64), vals,
              torch.tensor(vals)):
        got = ma.to_i64(x)
        assert got.dtype == torch.int64 and got.device == CPU
        np.testing.assert_array_equal(got.numpy().astype(np.uint64), want)
    small = ma.to_i64(np.array([[1, 2], [3, 4]], np.uint32))
    assert small.shape == (2, 2) and small.dtype == torch.int64
    with pytest.raises(ValueError, match="2\\^63"):
        ma.to_i64(np.array([2 ** 63], np.uint64))
