"""Parity of the port's kernels K1-K4, on the CPU through their plain
versions, with the JAX reference.

* The port's `FusedKeySwitch` (K1 intt_scale, K2 bconv_ntt_mulacc, K3
  moddown; 4 launches) equals the port's library ``core/ops.key_switch``
  for dnum 1/2/3, every level (ragged tail digits included), batch 1 and
  3, relin and Galois keys; the library route equals the reference's
  ``core/ops.key_switch`` at the top level of each dnum and at level 1 of
  dnum 2; and the fused route equals the reference's
  `FusedKeySwitch` run in interpret mode (as
  tests/test_keyswitch_fused.py runs it) for each dnum, ragged digits and
  a Galois key included. The reference's own tests already hold its
  fused route to its library route at every level. (The split keeps the
  reference's interpret-mode and first-call compile costs to a few calls.)
* 4 dispatches per apply, as tests/golden/dispatch_counts.json pins for
  the reference (read only here).
* `FusedKeySwitch.rescale` (K1 on the last limb, then K3; 2 launches)
  equals the port's library ``core/ops.rescale`` at every level, batch 1
  and 3, and the reference's ``core/ops.rescale`` at the top level.
* K4 (modmul) equals the reference's ``kernels.ops.modmul``, ragged N
  included.

Keys are carried from the reference with `repro_torch.core.carry`, so
both sides switch under identical key material. Every comparison is
``assert_array_equal``.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import ops as jops  # noqa: E402
from repro.core.context import CkksContext as JCtx  # noqa: E402
from repro.core.encryptor import CkksEncryptor as JEnc  # noqa: E402
from repro.core.params import test_params as j_test_params  # noqa: E402
from repro.kernels import ops as jkops  # noqa: E402
from repro.kernels.keyswitch import FusedKeySwitch as JFused  # noqa: E402
from repro_torch.core import ops as tops  # noqa: E402
from repro_torch.core.carry import context_tables, from_reference  # noqa: E402
from repro_torch.core.context import CkksContext as TCtx  # noqa: E402
from repro_torch.core.params import test_params as t_test_params  # noqa: E402
from repro_torch.kernels import common as kcom  # noqa: E402
from repro_torch.kernels import ops as tkops  # noqa: E402
from repro_torch.kernels.keyswitch import FusedKeySwitch  # noqa: E402

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden",
                           "dispatch_counts.json")
LOG_N = 7
N_LEVELS = 4
_STACKS = {}


def stack(dnum):
    """Reference and port contexts for one dnum, with the reference's
    relin key and one Galois key carried into the port (memoized)."""
    if dnum not in _STACKS:
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
        _STACKS[dnum] = dict(jctx=jctx, tctx=tctx, keys={
            "relin": (rk, c.rk), ("gk", elt): (gk, c.gks[elt])})
    return _STACKS[dnum]


def rand_d2(primes, batch, level, seed):
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, primes[j], size=(batch, 1 << LOG_N),
                         dtype=np.uint64) for j in range(level + 1)]
    return np.stack(cols, 1)


def t64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def eq(a, b):
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                  np.asarray(b).astype(np.int64))


@pytest.mark.parametrize("dnum", [1, 2, 3])
def test_fused_equals_library_every_level(dnum):
    s = stack(dnum)
    tctx = s["tctx"]
    fks = FusedKeySwitch(tctx)
    for key_id, (jkey, tkey) in s["keys"].items():
        for level in range(1, N_LEVELS + 1):
            d2 = rand_d2(tctx.primes, 3, level, seed=level)
            km = fks.ksk_mont(key_id, level, tkey.data)
            l0, l1 = tops.key_switch(tctx, t64(d2), level, tkey)
            for batch in (1, 3):
                e0, e1 = fks.apply(t64(d2[:batch]), level, km)
                eq(e0, l0[:batch])
                eq(e1, l1[:batch])
            if key_id == "relin" and (level == N_LEVELS
                                      or (dnum == 2 and level == 1)):
                r0, r1 = jops.key_switch(s["jctx"], jnp.asarray(d2[0]),
                                         level, jkey)
                eq(l0[0], r0)
                eq(l1[0], r1)


@pytest.mark.parametrize("dnum,level,key", [
    (1, 1, "gk"), (2, N_LEVELS, "relin"), (3, N_LEVELS, "relin")])
def test_fused_equals_reference_fused(dnum, level, key):
    """Against the reference's Pallas pipeline in interpret mode. Digit
    layouts: dnum 1 at level 1 -> one ragged digit of 2 (of 5); dnum 2 ->
    3 + 2; dnum 3 -> 2 + 2 + 1."""
    s = stack(dnum)
    key_id = next(k for k in s["keys"] if (k == "relin") == (key == "relin"))
    jkey, tkey = s["keys"][key_id]
    d2 = rand_d2(s["tctx"].primes, 3, level, seed=100 + level)
    jf = JFused(s["jctx"])
    r0, r1 = jf.apply(jnp.asarray(d2), level,
                      jf.ksk_mont(key_id, level, jkey.data), interpret=True)
    fks = FusedKeySwitch(s["tctx"])
    km = fks.ksk_mont(key_id, level, tkey.data)
    for batch in (1, 3):
        e0, e1 = fks.apply(t64(d2[:batch]), level, km)
        eq(e0, np.asarray(r0)[:batch])
        eq(e1, np.asarray(r1)[:batch])


def test_dispatches_per_apply_match_golden():
    with open(GOLDEN_PATH) as f:
        golden = json.load(f)
    for dnum in (1, 2, 3):
        tctx = stack(dnum)["tctx"]
        fks = FusedKeySwitch(tctx)
        _, rk = stack(dnum)["keys"]["relin"]
        for level in (1, N_LEVELS):
            g = golden[f"dnum{dnum}_level{level}"]
            assert len(tctx.params.digit_indices(level)) == g["digits"]
            km = fks.ksk_mont("relin", level, rk.data)
            for batch in (1, 4):
                d2 = t64(rand_d2(tctx.primes, batch, level, seed=7))
                kcom.reset_dispatch_count()
                fks.apply(d2, level, km)
                assert kcom.dispatch_count() == g["fused"] == \
                    FusedKeySwitch.DISPATCHES_PER_APPLY


@pytest.mark.parametrize("dnum", [1, 2])
def test_fused_rescale_equals_library_every_level(dnum):
    from repro_torch.core.ciphertext import Ciphertext
    s = stack(dnum)
    tctx = s["tctx"]
    fks = FusedKeySwitch(tctx)
    scale = 2.0 ** 26
    for level in range(1, N_LEVELS + 1):
        data = np.stack([rand_d2(tctx.primes, 3, level, seed=level + k)
                         for k in range(2)], 1)          # (3, 2, L, N)
        want = tops.rescale(tctx, Ciphertext(t64(data), level, scale))
        assert want.level == level - 1
        for batch in (1, 3):
            kcom.reset_dispatch_count()
            got = fks.rescale(t64(data[:batch]), level)
            assert kcom.dispatch_count() == \
                FusedKeySwitch.DISPATCHES_PER_RESCALE == 2
            eq(got, want.data[:batch])
        if level == N_LEVELS:
            from repro.core.ciphertext import Ciphertext as JCt
            ref = jops.rescale(s["jctx"], JCt(jnp.asarray(data[0]), level,
                                              scale))
            eq(got[0], ref.data)


@pytest.mark.parametrize("n", [512, 700])
def test_modmul_equals_reference(n):
    """K4's plain version through ops.modmul, against the reference's
    Pallas modmul (interpret mode), including N not a multiple of 512;
    then the engine's form: 2B ciphertext rows sharing one plaintext."""
    primes = [p for p in stack(2)["tctx"].primes[:3]]
    rng = np.random.default_rng(n)
    a = np.stack([rng.integers(0, p, size=n, dtype=np.uint64)
                  for p in primes * 2])
    b = np.stack([rng.integers(0, p, size=n, dtype=np.uint64)
                  for p in primes])
    b2 = np.concatenate([b, b])
    ref = jkops.modmul(jnp.asarray(a), jnp.asarray(b2), primes * 2,
                       interpret=True)
    eq(tkops.modmul(t64(a), t64(b2), primes * 2), ref)
    eq(tkops.modmul(t64(a), t64(b), primes), ref)
