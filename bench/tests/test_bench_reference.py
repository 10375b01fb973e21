"""The reference's own arithmetic against the program's, at small rings:
the same prime chain, its evaluation of the secret equal to the
program's forward NTT, its inverse NTT the inverse of that transform,
its lift and decode the inverse of the program's encoding. The
reference itself imports nothing of the program; only this test does."""
import numpy as np
import pytest
import torch

from bench import reference as ref

CKKS = {"log_n": 8, "n_levels": 23, "dnum": 4, "first_mod_bits": 31,
        "scale_mod_bits": 28, "special_mod_bits": 31}


def _ctx(log_n=8, **over):
    from repro_torch.core.context import CkksContext
    from repro_torch.core.params import CkksParams
    nums = dict(CKKS, log_n=log_n, log_scale=over.get("scale_mod_bits", 28))
    nums.update(over)
    return CkksContext(CkksParams(**nums), "cpu"), nums


@pytest.mark.parametrize("log_n, over", [
    (8, {}), (10, {}), (16, {}),
    (9, {"log_scale": 26, "scale_mod_bits": 26})])
def test_prime_chain_is_the_programs(log_n, over):
    from repro_torch.core.params import CkksParams
    nums = dict(CKKS, log_n=log_n, log_scale=28)
    nums.update(over)
    p = CkksParams(**nums)
    q, sp = ref.prime_chain(nums)
    assert q + sp == [m.value for m in p.moduli]


def test_secret_eval_is_the_forward_ntt():
    ctx, nums = _ctx()
    n = ctx.n
    rng = np.random.default_rng(5)
    s = np.zeros(n, dtype=np.int64)
    s[rng.choice(n, 64, replace=False)] = rng.choice([-1, 1], 64)
    idx = list(range(len(ctx.primes)))
    want = ctx.ntt(torch.from_numpy(s[None, :] % np.array(
        ctx.primes)[:, None]), idx)
    assert torch.equal(ref.secret_eval(s, ctx.primes), want)


def test_inverse_ntt_inverts_the_programs_transform():
    ctx, _ = _ctx()
    rng = np.random.default_rng(6)
    primes = ctx.primes[:5]
    x = torch.from_numpy(np.stack([rng.integers(0, p, size=(3, ctx.n))
                                   for p in primes]))
    fwd = torch.stack([ctx.ntt(x[i], [i]) for i in range(5)])
    assert torch.equal(ref.inverse_ntt(fwd, primes), x)


def test_lift_and_decode_invert_the_encoding():
    from repro_torch.core.encoder import CkksEncoder
    ctx, _ = _ctx()
    enc = CkksEncoder(ctx)
    rng = np.random.default_rng(7)
    v = rng.uniform(-1, 1, ctx.n // 2)
    level, scale = 6, 2.0 ** 40        # past two limbs: a 3-limb lift
    pt = enc.encode(v, scale, level)
    primes = ctx.primes[:level + 1]
    coeff = ref.inverse_ntt(pt[:, None, :], primes)
    vals, bad = ref.lift(coeff, primes)
    assert bad == 0
    z = ref.decode(vals, scale)[0]
    assert np.abs(z - v).max() < 1e-9


def test_lift_counts_coefficients_that_do_not_lift():
    ctx, _ = _ctx()
    primes = ctx.primes[:6]
    rng = np.random.default_rng(8)
    junk = torch.from_numpy(np.stack([rng.integers(0, p, size=(1, 64))
                                      for p in primes]))
    _, bad = ref.lift(junk, primes)
    assert bad == 64
    small = torch.from_numpy(np.stack([
        np.array([[5, -7 % p]]) for p in primes]))
    vals, bad = ref.lift(small, primes)
    assert bad == 0 and vals.tolist() == [[5.0, -7.0]]


def test_evaluate_rolls_and_multiplies():
    def prog(x, consts=None):
        return x.rotate(1) * consts["c"] + x
    x = np.arange(4.0)[None, :]
    out = ref.evaluate(prog, [x], {"c": np.full(4, 2.0)})[0]
    assert out.real.tolist() == [[2.0, 5.0, 8.0, 3.0]]
