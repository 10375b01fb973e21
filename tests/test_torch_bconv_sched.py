"""K6's launch on the CPU: ``kernels/bconv.bconv_sched`` mirrors the grid
of ``csrc/bconv.cu`` (column tiles by groups of ``GROUP`` destination
primes), its thread -> (output, column pair) mapping and its access width.

* every (output, column) is stored exactly once, and only by a live thread;
* no load reads past its row, and a 16-byte access starts on an even word;
* even n takes 16-byte words (two columns a thread), odd n or an unaligned
  base 8-byte words;
* the ragged cases: D not a multiple of GROUP, S = 1, odd S (the lazy
  schedule's leftover product), n smaller than one block;
* the model's sums, eager and lazy, equal ``bconv_plain`` at ``test_params``
  (ModUp and ModDown tables) and where the 32-bit prime 3221225473 is a
  source and a destination, and the reference's ``ops.bconv`` (interpret
  mode) at ``test_params``;
* the staged keyswitch's Montgomery weights, built once with the BConv
  tables, equal the ones ``ops.bconv`` converts per call.

Inputs come from numpy with fixed seeds; every comparison is exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import modarith as ma  # noqa: E402
from repro_torch.core.context import CkksContext  # noqa: E402
from repro_torch.core import params as tparams  # noqa: E402
from repro_torch.kernels import bconv as bc  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402

Q32 = 3221225473            # paper_params_bootstrap's 32-bit special prime

# (S, D, n): the staged keyswitch's full-width shapes and ragged N, fig14's
# N = 1024, the odd n of the card tests, and the ragged corners
SHAPES = [(6, 21, 65536), (3, 24, 65500), (6, 4, 1024), (6, 27, 777),
          (1, 21, 100), (7, 9, 36), (5, 8, 1), (2, 17, 4097)]


@pytest.mark.parametrize("s,d,n", SHAPES)
def test_every_output_stored_once(s, d, n):
    sch = bc.bconv_sched(s, d, n)
    st = sch.stores().reshape(-1, 2)
    assert ((st[:, 0] >= 0) & (st[:, 0] < d)).all()
    assert ((st[:, 1] >= 0) & (st[:, 1] < n)).all()
    flat = st[:, 0] * n + st[:, 1]
    assert torch.equal(torch.sort(flat).values, torch.arange(d * n))


@pytest.mark.parametrize("s,d,n", SHAPES)
def test_loads_stay_in_their_row(s, d, n):
    sch = bc.bconv_sched(s, d, n)
    words = sch.loads()                              # (live, S, vec)
    row = torch.arange(s)[None, :, None]
    col = words - row * n
    assert ((col >= 0) & (col < n)).all()
    # each access is `vec` adjacent words from a start on a vec boundary
    assert torch.equal(words - words[..., :1],
                       torch.arange(sch.vec).expand_as(words))
    assert (words[..., 0] % sch.vec == 0).all()
    # every live thread reads every row once; the dead ones read nothing
    assert words.shape == (int(sch.live().sum()), s, sch.vec)
    assert (sch.cols()[~sch.live()][:, 0] >= n).all()


@pytest.mark.parametrize("n,aligned,vec", [
    (65536, True, 2), (65500, True, 2), (2, True, 2), (777, True, 1),
    (1, True, 1), (65536, False, 1)])
def test_access_width(n, aligned, vec):
    assert bc.bconv_sched(6, 21, n, aligned).vec == vec


def test_grid():
    full = bc.bconv_sched(6, 21, 65536)
    assert (full.threads, full.grid) == (256, (128, 3))
    assert bc.bconv_sched(3, 24, 65536).grid == (128, 3)
    # fig14's shape: the block shrinks to a warp to spread over 16 blocks
    small = bc.bconv_sched(6, 4, 1024)
    assert (small.threads, small.grid) == (32, (16, 1))
    for s, d, n in SHAPES:
        sch = bc.bconv_sched(s, d, n)
        assert sch.grid[1] == -(-d // bc.GROUP)
        assert sch.grid[0] == -(-(-(-n // sch.vec)) // sch.threads)
        blocks = sch.grid[0] * sch.grid[1]
        assert (sch.threads == bc.MIN_THREADS or blocks >= bc.SPREAD)
        assert bc.MIN_THREADS <= sch.threads <= bc.THREADS
        # the last group is ragged exactly when GROUP does not divide D
        rows = sch.rows()
        assert int((rows < d).sum()) == d


@pytest.mark.parametrize("s", [0, bc.MAX_S + 1])
def test_s_outside_instances_raises(s):
    with pytest.raises(ValueError, match="instantiated"):
        bc.bconv_sched(s, 4, 64)


def _mont_weights(w, dst):
    p64, p32, pinv, rm = kops._mont_consts(tuple(dst), "cpu")
    return (ma.mulmod(w.T % p64[:, None], rm[:, None], p64[:, None])
            .to(torch.int32).contiguous(), p32, pinv)


def _check_model(v, w_mont, p32, pinv):
    s, n = v.shape
    for lazy in (False, True):
        want = bc.bconv_plain(v, w_mont, p32, pinv, lazy)
        got = bc.bconv_sched(s, w_mont.shape[0], n).run(v, w_mont, p32,
                                                         pinv, lazy)
        assert torch.equal(got, want)
        odd = bc.bconv_sched(s, w_mont.shape[0], n, aligned=False)
        assert torch.equal(odd.run(v, w_mont, p32, pinv, lazy), want)
    return want


@pytest.fixture(scope="module")
def ctx():
    return CkksContext(tparams.test_params(), "cpu")


@pytest.mark.parametrize("conv", ["modup_digit", "modup_tail", "moddown"])
def test_model_equals_plain_at_test_params(ctx, conv):
    level = ctx.params.n_levels
    digits = ctx.params.digit_indices(level)
    target = ctx.q_idx(level) + ctx.p_idx()
    src = {"modup_digit": digits[0], "modup_tail": digits[-1],
           "moddown": ctx.p_idx()}[conv]
    dst = ([i for i in target if i not in src] if conv != "moddown"
           else ctx.q_idx(level))
    tabs = ctx.bconv_tables(src, dst)
    rng = np.random.default_rng(len(src) + len(dst))
    v = torch.from_numpy(np.stack([rng.integers(0, ctx.primes[i], ctx.n)
                                   for i in src]))
    want = _check_model(v, tabs.w_mont, tabs.dst_q32, tabs.dst_qinv32)
    dst_p = [ctx.primes[i] for i in dst]
    ref = jops.bconv(jnp.asarray(v.numpy().astype(np.uint64)),
                     jnp.asarray(tabs.w.numpy().astype(np.uint64)), dst_p,
                     interpret=True)
    np.testing.assert_array_equal(np.asarray(ref).astype(np.int64),
                                  want.numpy())


@pytest.mark.parametrize("s,n", [(1, 100), (3, 777), (6, 1024), (7, 36)])
def test_model_equals_plain_at_32bit_prime(s, n):
    src = [Q32, 4293918721, 2013265921, 2113929217, 2130706433,
           2146959361, 4293230593][:s]
    dst = [Q32, 2013265921, 132120577, 1073479681, 469762049, 4293918721,
           754974721, 167772161, 377487361]
    rng = np.random.default_rng(s * n)
    v = np.stack([rng.integers(0, p, n) for p in src])
    v[:, :4] = np.array(src)[:, None] - 1          # sums past 2^32
    w = rng.integers(0, 1 << 32, size=(s, len(dst)))
    _check_model(torch.from_numpy(v),
                 *_mont_weights(torch.from_numpy(w), dst))


def test_staged_weights_built_once_equal_per_call_conversion(ctx):
    level = ctx.params.n_levels
    for src, dst in ((ctx.params.digit_indices(level)[0],
                      ctx.q_idx(level)[3:] + ctx.p_idx()),
                     (ctx.p_idx(), ctx.q_idx(level))):
        tabs = ctx.bconv_tables(src, dst)
        assert ctx.bconv_tables(src, dst).w_mont is tabs.w_mont
        w_mont, p32, pinv = _mont_weights(
            tabs.w, [ctx.primes[i] for i in dst])
        for mine, theirs in ((tabs.w_mont, w_mont), (tabs.dst_q32, p32),
                             (tabs.dst_qinv32, pinv)):
            assert mine.dtype == torch.int32
            assert torch.equal(mine, theirs)
