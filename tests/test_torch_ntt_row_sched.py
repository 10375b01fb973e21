"""K7's row kernel as its threads compute it, on the CPU.

``ntt.ntt_row_sched`` models ``csrc/ntt.cu::ntt_row_kernel``: C / 16
threads a row holding 16 values each in registers (one thread a row where
C <= 16), the t2 product formed as the first pass loads its values, the
stages as the radix passes of ``common.sched_passes``, the exchanges
through a per-row buffer laid out by ``ntt.row_word``, and ``row_block``
rows a block. Here it is held to ``ntt_row_plain`` for every row length
the C entry instantiates (C = 1 to 16384) at a 30-bit prime and at
3221225473 and, where the
reference's interpret mode is quick (log_n <= 10, R > 1), to the JAX
four-step NTT; its buffer is shown free of bank conflicts at C = 256, and
the rows-a-block rule within a block's 1024 threads and shared memory.

Inputs come from numpy with fixed seeds; every comparison is exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.params import find_2nth_root  # noqa: E402
from repro.core.params import find_ntt_primes  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ntt as tntt  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.common import sched_passes, sched_pos  # noqa: E402

Q32 = 3221225473            # paper_params_bootstrap's 32-bit special prime

# (log_n, log_c) for every log C the C entry takes: one thread a row
# (C <= 16), one exchange (C = 32 to 256), two (512 to 4096), three
# (8192, 16384); the rows' threads within one warp up to C = 512, a block
# barrier above; fig14's R = C = 64 and the full width's R = C = 256
SHAPES = [(6, 0), (6, 1), (8, 2), (8, 3), (8, 4), (10, 5), (12, 6),
          (10, 7), (16, 8), (10, 9), (12, 10), (14, 11), (14, 12),
          (16, 13), (16, 14)]


def _kernel(q, log_n, log_c):
    q = q or find_ntt_primes(30, log_n, 1)[0].value
    psi = find_2nth_root(q, 2 << log_n)
    return q, psi, tops.NttKernel(q, psi, log_n, log_n - log_c)


@pytest.mark.parametrize("q", [None, Q32])
@pytest.mark.parametrize("log_n,log_c", SHAPES)
def test_ntt_row_schedule_equals_plain(log_n, log_c, q):
    q, psi, kern = _kernel(q, log_n, log_c)
    kt = kern.tables("cpu")
    a = torch.from_numpy(np.random.default_rng(log_n + log_c).integers(
        0, q, 1 << log_n))
    y = tntt.ntt_col_plain(a, kt)
    assert torch.equal(tntt.ntt_row_sched(y, kt), tntt.ntt_row_plain(y, kt))
    # the reference wraps at Q32 and needs R > 1 and C > 1
    if q != Q32 and log_n <= 10 and 0 < log_c < log_n:
        ref = jops.NttKernel(q, psi, log_n, log_n - log_c)(
            jnp.asarray(a.numpy().astype(np.uint64)), interpret=True)
        np.testing.assert_array_equal(
            tntt.ntt_row_sched(y, kt).numpy(),
            np.asarray(ref).astype(np.int64))


def test_ntt_row_block_fits_a_block():
    """For every (R, C) of N <= 2^16 the C entry takes, `row_block`
    divides R, fills a block up to `ROW_THREADS` threads (one row where a
    row takes more), and keeps it within the kernel's launch bound, 1024
    threads and the shared memory a block may use; at R = C = 256 the
    grid has more than 32 blocks."""
    for log_c in range(tntt.MAX_ROW_LOG_C + 1):
        c = 1 << log_c
        for log_r in range(17 - log_c):
            r = 1 << log_r
            rows = tntt.row_block(log_c, r)
            assert rows >= 1 and r % rows == 0, (log_c, r, rows)
            t = tntt.row_threads(log_c)
            block = rows * t
            assert block <= max(t, tntt.ROW_MAX_THREADS) <= tntt.MAX_THREADS
            assert block == min(r * t, max(tntt.ROW_THREADS, t))
            if log_c > 4:
                assert 4 * rows * tntt.row_words(c) <= tntt.SMEM_BYTES
    assert 256 // tntt.row_block(8, 256) > 32


def test_ntt_row_exchange_without_bank_conflicts_at_c256():
    """At C = 256 a block's rows x 16 threads (thread t: row t // 16 of
    the block, row thread t % 16) store the first pass's values and load
    the last pass's through `row_word`: every word of the block's buffer
    once, and no access of a warp hits a bank twice."""
    log_c, c = 8, 256
    rows = tntt.row_block(log_c, c)
    t = torch.arange(rows * 16)
    lrow, tid = t // 16, t % 16
    j = torch.arange(16)[None, :]
    base = (lrow * tntt.row_words(c))[:, None]
    patterns = [sched_pos(log_c, st, lr, tid[:, None], j)[0]
                for st, lr in sched_passes(log_c)]
    every = None
    for pos in patterns:
        words = base + tntt.row_word(pos)
        assert len(set(words.flatten().tolist())) == rows * c
        every = every or set(words.flatten().tolist())
        assert set(words.flatten().tolist()) == every
        assert max(every) < rows * tntt.row_words(c)
        for v in range(pos.shape[1]):
            for warp in (words[:, v] % 32).split(32):
                assert len(set(warp.tolist())) == len(warp), v
