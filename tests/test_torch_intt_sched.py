"""The inverse-NTT schedule of the port's K1 (intt_scale), modelled on the
CPU, and K1's parity with the reference's `_intt_scale_kernel`.

On the card K1 runs a row's Gentleman-Sande inverse NTT as one
thread-block cluster of NCH chunk blocks (csrc/common.cuh::intt_cluster):
each block loads its chunk once, runs the in-chunk stages as radix passes
in registers from the smallest stride up, and the blocks exchange the NCH
values of the cross-chunk stages through distributed shared memory.
`kernels/keyswitch.intt_sched` is that schedule on int64 tensors with the
same index formulas. Here it is held equal to the plain butterflies
`_gs_stages` and to the reference's `_gs_stages_last` (primes < 2^31; the
reference's u32 sums wrap at the 32-bit prime), and its layout to the
claims the kernel rests on: every position read once and written once,
every pass a partition of the chunk, no shared-memory bank hit twice by
one access (the gathers from the peers included), 3 block barriers and 2
cluster barriers at C = 16384. Every comparison is exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from repro.core.context import CkksContext as JCtx  # noqa: E402
from repro.core.params import test_params as j_test_params  # noqa: E402
from repro.kernels.keyswitch import FusedKeySwitch as JFused  # noqa: E402
from repro.kernels.keyswitch import _gs_stages_last  # noqa: E402
from repro.kernels.keyswitch import _intt_scale_kernel  # noqa: E402
from repro_torch.core import modarith as ma  # noqa: E402
from repro_torch.core.context import CkksContext as TCtx  # noqa: E402
from repro_torch.core.ntt import NttTables  # noqa: E402
from repro_torch.core.params import Modulus  # noqa: E402
from repro_torch.core.params import test_params as t_test_params  # noqa: E402
from repro_torch.kernels import keyswitch as ks  # noqa: E402
from repro_torch.kernels.common import (mont_mul32, qinv_neg32,  # noqa: E402
                                        u32)

Q32 = 3221225473            # the 32-bit special prime of paper parameters
BANKS = 32
_ref_gs = jax.jit(_gs_stages_last)   # one compile per shape, not per op


def _inputs(primes, log_n, seed):
    tab = NttTables([Modulus(p) for p in primes], log_n, "cpu")
    q = tab.q[:, None]
    rm = torch.tensor([(1 << 32) % p for p in primes])[:, None]
    irp = ma.mulmod(tab.inv_root_powers, rm, q)
    qi = torch.tensor([qinv_neg32(p) for p in primes])[:, None]
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(np.stack([rng.integers(0, p, 1 << log_n)
                                   for p in primes]))
    return x, irp, q, qi


def _test_primes(log_n):
    # the chain of test_params at this ring degree: primes < 2^31
    return [m.value for m in t_test_params(log_n=log_n).moduli[:2]]


def _ref_rows(x, irp, primes):
    return np.stack([np.asarray(_ref_gs(
        jnp.asarray(x[r:r + 1].numpy(), jnp.uint32),
        jnp.asarray(irp[r].numpy(), jnp.uint32), jnp.uint32(p),
        jnp.uint32(qinv_neg32(p))))[0] for r, p in enumerate(primes)])


@pytest.mark.parametrize("kind", ["test_params", "q32"])
@pytest.mark.parametrize("log_c", [5, 6, 7, 8])     # first radix 2, 4, 8, 16
@pytest.mark.parametrize("nch", [1, 2, 4])
def test_schedule_equals_gs_stages(nch, log_c, kind):
    log_n = log_c + nch.bit_length() - 1
    primes = [Q32] if kind == "q32" else _test_primes(log_n)
    x, irp, q, qi = _inputs(primes, log_n, seed=nch * 100 + log_c)
    got = ks.intt_sched(x, irp, q, qi, nch)
    assert torch.equal(got, ks._gs_stages(x, irp, q, qi))
    if kind == "test_params":
        np.testing.assert_array_equal(
            _ref_rows(x, irp, primes).astype(np.int64), got.numpy())


@pytest.mark.parametrize("log_n,nch", [(16, 4), (15, 2), (10, 1)])
def test_schedule_at_kernel_shapes(log_n, nch):
    """The shapes the C entry launches: 2^16 as a cluster of 4 chunks of
    16384, 2^15 as 2, 2^10 as one block; the 32-bit prime beside a test
    prime."""
    primes = [Q32, _test_primes(log_n)[0]]
    x, irp, q, qi = _inputs(primes, log_n, seed=log_n)
    got = ks.intt_sched(x, irp, q, qi, nch)
    assert torch.equal(got, ks._gs_stages(x, irp, q, qi))
    np.testing.assert_array_equal(
        _ref_rows(x[1:], irp[1:], primes[1:]).astype(np.int64),
        got[1:].numpy())


def _grid(log_c):
    tid = torch.arange(1 << (log_c - 4))[:, None]
    return tid, torch.arange(ks.SCHED_VALS)[None, :]


def _passes(log_c):
    """The in-chunk passes in the order K1 runs them, with each one's
    positions (threads, 16) and its words per shared-memory access."""
    tid, j = _grid(log_c)
    out = []
    for st, lr in ks.sched_passes(log_c)[::-1]:
        pos, _ = ks.sched_pos(log_c, st, lr, tid, j)
        last = st + lr == log_c
        out.append((f"pass@{st}", pos, min(4, 1 << lr) if last else 1))
    return out


@pytest.mark.parametrize("log_c", [5, 6, 7, 8, 9, 10, 13, 14])
def test_layout_reads_and_writes_each_position_once(log_c):
    """The first pass's loads from device memory, every pass, and the
    final stores (the last pass's positions) each touch every chunk
    position once: the chunk is read once and written once."""
    c_len = 1 << log_c
    passes = _passes(log_c)
    assert passes[0][2] > 1            # contiguous sets from device memory
    for name, pos, _ in passes:
        assert torch.equal(pos.flatten().sort().values,
                           torch.arange(c_len)), name
    tid, j = _grid(log_c)
    stores = passes[-1][1]
    assert torch.equal(stores, tid + j * (c_len >> 4))   # coalesced


def test_no_bank_conflicts_at_chunk_16384():
    """At C = 16384 (N = 2^15, 2^16) no access of a warp hits a
    shared-memory bank twice: the first pass's 16-byte stores over each
    quarter warp of 8 threads, the radix-16 passes' loads and stores and
    the exchange's stores over 32 threads, and the gathers of the NCH
    values from each peer's buffer (the same positions in every peer)."""
    passes = _passes(14)
    accesses = list(passes)
    accesses.append(("exchange store", passes[-1][1], 1))
    accesses.append(("dsmem gather", passes[-1][1], 1))
    for name, pos, width in accesses:
        ph = ks.sched_phys(pos)
        group = 32 if width == 1 else 32 // width
        for v in range(0, ks.SCHED_VALS, width):
            words = ph[:, v:v + 1] + torch.arange(width)[None, :]
            banks = (words % BANKS).reshape(-1, group * width)
            for row in banks:
                assert len(set(row.tolist())) == group * width, (name, v)


def test_barriers_at_chunk_16384():
    """Four passes (2 + 4 + 4 + 4 stages from stride 1 up) at C = 16384:
    3 block barriers between them, against 14 stages; the two cluster
    barriers fence the exchange (NCH > 1)."""
    passes = ks.sched_passes(14)[::-1]
    assert [lr for _, lr in passes] == [2, 4, 4, 4]
    assert len(passes) - 1 == 3
    assert sum(lr for _, lr in passes) + 2 == 16       # + log2(NCH = 4)


def _reference_k1(x, row0, n_rows, irp, q32, qi32, sc):
    """The reference's `_intt_scale_kernel` as its FusedKeySwitch launches
    it (grid (batch, rows)), in interpret mode."""
    b, _, n = x.shape
    row = pl.BlockSpec((1, 1, n), lambda i, j: (i, row0 + j, 0))
    limb = pl.BlockSpec((1, n), lambda i, j: (j, 0))
    scal = pl.BlockSpec((1, 1), lambda i, j: (j, 0))
    return np.asarray(pl.pallas_call(
        _intt_scale_kernel, grid=(b, n_rows),
        in_specs=[row, limb, scal, scal, scal],
        out_specs=pl.BlockSpec((1, 1, n), lambda i, j: (i, j, 0)),
        out_shape=jax.ShapeDtypeStruct((b, n_rows, n), jnp.uint32),
        interpret=True,
    )(jnp.asarray(x, jnp.uint32), irp, q32[:, None], qi32[:, None],
      sc[:, None]))


def test_k1_matches_reference_intt_scale_kernel():
    """At test_params (logN = 10, all primes < 2^31), both launches of a
    keyswitch: stage A over the Q limbs of a batch and C1 over the special
    limbs of the accumulators. The port's K1 (its plain version, which the
    CPU route runs) and its schedule model times the scale equal the
    reference's Pallas kernel, each side on its own tables."""
    params = dict(log_n=10, n_levels=4, dnum=2)
    level = 4
    jt = JFused(JCtx(j_test_params(**params)))._tables(level)
    tt = ks.FusedKeySwitch(TCtx(t_test_params(**params), "cpu"))._tables(
        level)
    l, n_p = level + 1, tt.n_p
    n = 1 << params["log_n"]
    primes = u32(tt.q_q32).tolist() + u32(tt.p_q32).tolist()
    rng = np.random.default_rng(14)
    x = np.stack([np.stack([rng.integers(0, p, n) for p in primes])
                  for _ in range(2)]).astype(np.uint32)
    launches = (
        (0, l, (tt.q_irp_m, tt.q_q32, tt.q_qi32, tt.q_scale_m),
         (jt.q_irp_m, jt.q_q32, jt.q_qi32, jt.q_scale_m)),
        (l, n_p, (tt.p_irp_m, tt.p_q32, tt.p_qi32, tt.p_scale_m),
         (jt.p_irp_m, jt.p_q32, jt.p_qi32, jt.p_scale_m)))
    xt = torch.from_numpy(x.view(np.int32))
    for row0, n_rows, ttab, jtab in launches:
        want = _reference_k1(x, row0, n_rows, *jtab).astype(np.int64)
        got = ks.intt_scale(xt, row0, n_rows, *ttab)
        np.testing.assert_array_equal(u32(got).numpy(), want)
        irp, q32, qi32, sc = (u32(t) for t in ttab)
        q, qi = q32[:, None], qi32[:, None]
        rows = u32(xt[:, row0:row0 + n_rows]).reshape(-1, n)
        sched = ks.intt_sched(rows, irp.repeat(2, 1), q.repeat(2, 1),
                              qi.repeat(2, 1), nch=1)
        scaled = mont_mul32(sched.reshape(2, n_rows, n), sc[:, None], q, qi)
        np.testing.assert_array_equal(scaled.numpy(), want)
