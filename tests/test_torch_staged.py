"""The port's staged keyswitch (``kernels/keyswitch.keyswitch_staged``:
K4 modmul, K6 bconv and K5 mulacc plus library NTTs, one dispatch per
stage) on the CPU, through the kernels' plain versions.

* Bit-equal to the reference's ``keyswitch_staged(..., interpret=True)``
  at ``test_params`` with dnum 1, 2 and 3 (relin and Galois keys carried
  from the reference with `repro_torch.core.carry`), a ragged tail digit
  included.
* Equal to the port's own fused (`FusedKeySwitch`) and library
  (``core/ops.key_switch``) keyswitches, also at parameters that draw the
  32-bit special primes 3221225473 and 4293918721, where the reference's
  u32 kernels wrap (fault F2) and only the port is compared.
* 7·digits + 10 dispatches, equal to ``staged`` in
  tests/golden/dispatch_counts.json for each (dnum, level) there (read
  as data), and 4 for the fused route.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.context import CkksContext as JCtx  # noqa: E402
from repro.core.encryptor import CkksEncryptor as JEnc  # noqa: E402
from repro.core.params import test_params as j_test_params  # noqa: E402
from repro.kernels.keyswitch import keyswitch_staged as j_staged  # noqa: E402
from repro_torch.core import ops as tops  # noqa: E402
from repro_torch.core.carry import context_tables, from_reference  # noqa: E402
from repro_torch.core.context import CkksContext as TCtx  # noqa: E402
from repro_torch.core.encryptor import CkksEncryptor as TEnc  # noqa: E402
from repro_torch.core.params import CkksParams  # noqa: E402
from repro_torch.core.params import test_params as t_test_params  # noqa: E402
from repro_torch.kernels import common as kcom  # noqa: E402
from repro_torch.kernels.keyswitch import FusedKeySwitch  # noqa: E402
from repro_torch.kernels.keyswitch import keyswitch_staged  # noqa: E402

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden",
                           "dispatch_counts.json")
LOG_N = 7
N_LEVELS = 4


def _d2(primes, level, seed, n=1 << LOG_N):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, primes[j], size=n)
                     for j in range(level + 1)])


def _staged(ctx, d2, level, key):
    kcom.reset_dispatch_count()
    out = keyswitch_staged(ctx, d2, level, key)
    return out, kcom.dispatch_count()


def _port_routes_agree(ctx, d2, level, key):
    """Staged == fused == library on one row; returns the staged pair
    and its dispatch count."""
    (s0, s1), n_disp = _staged(ctx, d2, level, key)
    fks = FusedKeySwitch(ctx)
    e0, e1 = fks.apply(d2[None], level, fks.ksk_mont("k", level, key.data))
    r0, r1 = tops.key_switch(ctx, d2, level, key)
    for x0, x1 in ((e0[0], e1[0]), (r0, r1)):
        assert torch.equal(s0, x0) and torch.equal(s1, x1)
    return (s0, s1), n_disp


@pytest.mark.parametrize("dnum", [1, 2, 3])
def test_staged_matches_reference(dnum):
    kw = dict(log_n=LOG_N, n_levels=N_LEVELS, dnum=dnum, log_scale=26)
    jctx = JCtx(j_test_params(**kw))
    tctx = TCtx(t_test_params(**kw), "cpu")
    jenc = JEnc(jctx, seed=11)
    sk = jenc.keygen()
    rk = jenc.relin_keygen(sk)
    elt = jctx.rotation_element(3)
    gk = jenc.galois_keygen(sk, [elt])[elt]
    c = from_reference(tctx, rk=np.asarray(rk.data),
                       gks={elt: np.asarray(gk.data)},
                       tables=context_tables(jctx))
    # one reference call per dnum (its interpret mode compiles per
    # shape): dnum 2 at the top level has a ragged tail digit (3 + 2)
    level = N_LEVELS - (dnum == 3)
    jkey, tkey = (gk, c.gks[elt]) if dnum == 2 else (rk, c.rk)
    d2 = _d2(jctx.primes, level, dnum)
    w0, w1 = j_staged(jctx, jnp.asarray(d2.astype(np.uint64)), level, jkey,
                      interpret=True)
    (s0, s1), n_disp = _port_routes_agree(tctx, torch.from_numpy(d2), level,
                                          tkey)
    np.testing.assert_array_equal(s0.numpy(), np.asarray(w0))
    np.testing.assert_array_equal(s1.numpy(), np.asarray(w1))
    assert n_disp == 7 * len(tctx.params.digit_indices(level)) + 10


@pytest.mark.parametrize("level", [7, 3])
def test_staged_exact_at_32bit_primes(level):
    """n_levels 7, dnum 1: eight special primes, 3221225473 and
    4293918721 among them."""
    params = CkksParams(log_n=LOG_N, log_scale=28, n_levels=7, dnum=1,
                        first_mod_bits=31, scale_mod_bits=28,
                        special_mod_bits=31)
    ctx = TCtx(params, "cpu")
    assert {3221225473, 4293918721} <= set(ctx.p_primes)
    enc = TEnc(ctx, seed=5)
    rk = enc.relin_keygen(enc.keygen())
    d2 = torch.from_numpy(_d2(ctx.primes, level, level))
    _, n_disp = _port_routes_agree(ctx, d2, level, rk)
    assert n_disp == 17


def test_staged_dispatch_counts_match_golden():
    with open(GOLDEN_PATH) as f:
        golden = json.load(f)
    for key, want in golden.items():
        dnum, level = (int(x) for x in
                       key.replace("dnum", "").split("_level"))
        ctx = TCtx(t_test_params(log_n=6, n_levels=N_LEVELS, dnum=dnum,
                                 log_scale=26), "cpu")
        enc = TEnc(ctx, seed=1)
        rk = enc.relin_keygen(enc.keygen())
        d2 = torch.from_numpy(_d2(ctx.primes, level, 0, ctx.n))
        _, n_disp = _staged(ctx, d2, level, rk)
        fks = FusedKeySwitch(ctx)
        kcom.reset_dispatch_count()
        fks.apply(d2[None], level, fks.ksk_mont("relin", level, rk.data))
        assert {"digits": len(ctx.params.digit_indices(level)),
                "fused": kcom.dispatch_count(), "staged": n_disp} == want
