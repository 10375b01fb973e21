"""The forward-NTT schedule of the port's K2 (bconv_ntt_mulacc) and K3
(moddown), modelled on the CPU.

On the card K2 and K3 run a row's forward NTT as one thread-block cluster
of NCH chunk blocks (csrc/common.cuh::ntt_fwd_cluster): each block forms
its chunk of the BConv once, the blocks exchange the NCH values of the
cross-chunk stages through distributed shared memory, and the in-chunk
stages run as radix passes in registers. `kernels/keyswitch.ntt_fwd_sched`
is that schedule on int64 tensors with the same index formulas. Here it is
held equal to the plain butterflies `_ct_stages` and to the reference's
`_ct_stages_last` (primes < 2^31; the reference's u32 sums wrap at the
32-bit prime), to the library NTT, and its layout to the claims the
kernels rest on: every position formed once, every pass a partition of
the chunk, no shared-memory bank hit twice by one access, at most 4 block
barriers at C = 16384. Every comparison is exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.keyswitch import _ct_stages_last  # noqa: E402
from repro_torch.core import modarith as ma  # noqa: E402
from repro_torch.core.ntt import NttTables, ntt_forward  # noqa: E402
from repro_torch.core.params import Modulus  # noqa: E402
from repro_torch.core.params import test_params as t_test_params  # noqa: E402
from repro_torch.kernels import keyswitch as ks  # noqa: E402
from repro_torch.kernels.common import qinv_neg32  # noqa: E402

Q32 = 3221225473            # the 32-bit special prime of paper parameters
BANKS = 32
_ref_ct = jax.jit(_ct_stages_last)   # one compile per shape, not per op


def _inputs(primes, log_n, seed):
    mods = [Modulus(p) for p in primes]
    tab = NttTables(mods, log_n, "cpu")
    q = tab.q[:, None]
    rm = torch.tensor([(1 << 32) % p for p in primes])[:, None]
    rp = ma.mulmod(tab.root_powers, rm, q)
    qi = torch.tensor([qinv_neg32(p) for p in primes])[:, None]
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(np.stack([rng.integers(0, p, 1 << log_n)
                                   for p in primes]))
    return x, rp, q, qi, tab


def _primes(kind, log_n):
    if kind == "q32":
        return [Q32]
    # the chain of test_params at this ring degree: primes < 2^31
    return [m.value for m in t_test_params(log_n=log_n).moduli[:2]]


@pytest.mark.parametrize("kind", ["test_params", "q32"])
@pytest.mark.parametrize("log_c", [5, 6, 7, 8])     # last radix 2, 4, 8, 16
@pytest.mark.parametrize("nch", [1, 2, 4])
def test_schedule_equals_plain_ntt(nch, log_c, kind):
    log_n = log_c + nch.bit_length() - 1
    primes = _primes(kind, log_n)
    x, rp, q, qi, tab = _inputs(primes, log_n, seed=nch * 100 + log_c)
    got = ks.ntt_fwd_sched(x, rp, q, qi, nch)
    assert torch.equal(got, ks._ct_stages(x, rp, q, qi))
    assert torch.equal(got, ntt_forward(x, tab.root_powers, tab.q))
    if kind == "q32":
        return
    for r, p in enumerate(primes):
        ref = _ref_ct(jnp.asarray(x[r:r + 1].numpy(), jnp.uint32),
                              jnp.asarray(rp[r].numpy(), jnp.uint32),
                              jnp.uint32(p), jnp.uint32(qinv_neg32(p)))
        np.testing.assert_array_equal(np.asarray(ref)[0].astype(np.int64),
                                      got[r].numpy())


@pytest.mark.parametrize("log_n,nch", [(16, 4), (15, 2), (10, 1)])
def test_schedule_at_kernel_shapes(log_n, nch):
    """The shapes the C entry launches: 2^16 as a cluster of 4 chunks of
    16384, 2^15 as 2, 2^10 as one block; the 32-bit prime beside a test
    prime."""
    primes = [Q32, _primes("test_params", log_n)[0]]
    x, rp, q, qi, _ = _inputs(primes, log_n, seed=log_n)
    got = ks.ntt_fwd_sched(x, rp, q, qi, nch)
    assert torch.equal(got, ks._ct_stages(x, rp, q, qi))
    ref = _ref_ct(jnp.asarray(x[1:].numpy(), jnp.uint32),
                          jnp.asarray(rp[1].numpy(), jnp.uint32),
                          jnp.uint32(primes[1]),
                          jnp.uint32(qinv_neg32(primes[1])))
    np.testing.assert_array_equal(np.asarray(ref)[0].astype(np.int64),
                                  got[1].numpy())


def _accesses(log_c):
    """Every shared-memory access pattern of the schedule: (name,
    positions (threads, 16), words per access)."""
    tid = torch.arange(1 << (log_c - 4))[:, None]
    j = torch.arange(ks.SCHED_VALS)[None, :]
    out = [("bconv runs", ks.sched_run_pos(log_c, tid, j), 4)]
    for st, lr in ks.sched_passes(log_c):
        pos, _ = ks.sched_pos(log_c, st, lr, tid, j)
        last = st + lr == log_c
        out.append((f"pass@{st}", pos, min(4, 1 << lr) if last else 1))
    return out


@pytest.mark.parametrize("log_c", [5, 6, 7, 8, 9, 10, 13, 14])
def test_layout_partitions_chunk(log_c):
    """Each BConv output is formed by one thread of one block (so once in
    the grid), each pass touches every chunk position once, and the padded
    buffer holds the chunk without collisions."""
    c_len = 1 << log_c
    for name, pos, _ in _accesses(log_c):
        assert torch.equal(pos.flatten().sort().values,
                           torch.arange(c_len)), name
    ph = ks.sched_phys(torch.arange(c_len))
    assert len(set(ph.tolist())) == c_len
    assert int(ph.max()) < c_len + ((c_len >> 6) << 2)


def test_no_bank_conflicts_at_chunk_16384():
    """At C = 16384 (N = 2^15, 2^16) no access of a warp hits a
    shared-memory bank twice: scalar accesses over 32 threads, 16-byte
    accesses over each quarter warp of 8 threads."""
    for name, pos, width in _accesses(14):
        ph = ks.sched_phys(pos)
        group = 32 if width == 1 else 32 // width
        for v in range(0, ks.SCHED_VALS, width):
            words = ph[:, v:v + 1] + torch.arange(width)[None, :]
            banks = (words % BANKS).reshape(-1, group * width)
            for row in banks:
                assert len(set(row.tolist())) == group * width, (name, v)


def test_barriers_at_chunk_16384():
    """Three block barriers between the four radix passes (4 + 4 + 4 + 2
    stages) at C = 16384, against 14 stages; the kernels add the two
    cluster barriers of the exchange."""
    passes = ks.sched_passes(14)
    assert [lr for _, lr in passes] == [4, 4, 4, 2]
    assert len(passes) - 1 <= 4
