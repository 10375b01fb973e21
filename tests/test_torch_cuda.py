"""The port's CUDA kernels against their plain versions, on a CUDA card.

Every test carries the ``cuda`` marker and skips (inside the fixture)
where there is no CUDA device, as on a CPU-only runner; there
chip_smoke.py is what holds the kernels to their plain versions. Run on
the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Covers every chunking of the NTT kernels (N = 2^10: one chunk in shared
memory; 2^15: two; 2^16: four), a 32-bit special prime, ragged tail
digits, a ragged K4 row length, and one launch count per wrapper call.
Imports nothing of JAX, so it runs where only torch is installed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import ops as hops  # noqa: E402
from repro_torch.core.context import CkksContext  # noqa: E402
from repro_torch.core.encryptor import CkksEncryptor  # noqa: E402
from repro_torch.core.params import CkksParams  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels import keyswitch as ks  # noqa: E402
from repro_torch.kernels import modmul as mm  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402

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
