"""Parity of the port's homomorphic linear algebra
(repro_torch.core.linalg) with the JAX reference (repro.core.linalg), on
the CPU at tests/test_linalg.py's parameters (test_params(log_n=8,
n_levels=4, dnum=2, log_scale=26)).

Both packages draw their keys and ciphertexts from encryptors of one
seed, in one order, so every ciphertext limb and key is held bit for bit
(``assert_array_equal``), and the host float arrays (diagonals, Chebyshev
coefficients) with ``array_equal``. The decrypts are also held to the
plaintext result within tests/test_linalg.py's tolerances.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import Pair, eq_ct, eq_keys  # noqa: E402
from repro.core import linalg as jla  # noqa: E402
from repro.core import ops as jops  # noqa: E402
from repro.core.params import test_params as j_test_params  # noqa: E402
from repro_torch.core import linalg as tla  # noqa: E402
from repro_torch.core import ops as tops  # noqa: E402
from repro_torch.core.params import test_params as t_test_params  # noqa: E402

PARAMS = dict(log_n=8, n_levels=4, dnum=2, log_scale=26)
SCALE = 2.0 ** 26
STEPS = [1, 5, 17]


def banded_matrix(s, rng, n_diag=6):
    m = np.zeros((s, s), dtype=np.complex128)
    for d in rng.choice(s, size=n_diag, replace=False):
        dg = rng.normal(size=s) * 0.3
        for j in range(s):
            m[j, (j + d) % s] = dg[j]
    return m


@pytest.fixture(scope="module")
def st():
    """Both stacks with relin key, rotation keys for STEPS and the
    matvec's Galois keys, drawn in one order on both sides."""
    p = Pair(j_test_params(**PARAMS), t_test_params(**PARAMS), seed=7)
    rng = np.random.default_rng(1234)
    s = p.jctx.n // 2
    mat = banded_matrix(s, rng)
    jdiags, tdiags = jla.matrix_diagonals(mat), tla.matrix_diagonals(mat)
    keys = dict(
        jrk=p.jenc.relin_keygen(p.jsk), trk=p.tenc.relin_keygen(p.tsk),
        jgks=p.jenc.rotation_keygen(p.jsk, STEPS),
        tgks=p.tenc.rotation_keygen(p.tsk, STEPS))
    jelts = jla.matvec_keys_needed(p.jctx, jdiags)
    assert jelts == tla.matvec_keys_needed(p.tctx, tdiags)
    keys.update(jmk=p.jenc.galois_keygen(p.jsk, jelts),
                tmk=p.tenc.galois_keygen(p.tsk, jelts))
    v = 0.5 * (rng.normal(size=s) + 1j * rng.normal(size=s))
    x = rng.uniform(-1, 1, size=s)
    return dict(p=p, s=s, mat=mat, jdiags=jdiags, tdiags=tdiags, v=v, x=x,
                ct_v=p.encrypt(v, SCALE, PARAMS["n_levels"]),
                ct_x=p.encrypt(x + 0j, SCALE, PARAMS["n_levels"]), **keys)


def test_keys_bit_equal(st):
    eq_keys({0: st["jrk"]}, {0: st["trk"]})
    eq_keys(st["jgks"], st["tgks"])
    eq_keys(st["jmk"], st["tmk"])


def test_host_floats_equal(st):
    assert sorted(st["jdiags"]) == sorted(st["tdiags"])
    for d in st["jdiags"]:
        assert np.array_equal(st["jdiags"][d], st["tdiags"][d])
    for fn, deg in ((np.cos, 20), (lambda t: np.sin(0.5 * np.pi * t), 7),
                    (lambda t: np.sin(2 * np.pi * 6.0 * t), 63)):
        assert np.array_equal(jla.chebyshev_coeffs(fn, deg),
                              tla.chebyshev_coeffs(fn, deg))
    for n_d in (1, 6, 16, 64, 2048):
        assert jla.bsgs_split(range(n_d), 128) == tla.bsgs_split(
            range(n_d), 128)
    assert jla.required_rotation_steps(st["jdiags"], st["s"]) == \
        tla.required_rotation_steps(st["tdiags"], st["s"])


def test_hoisted_rotations_bit_equal(st):
    p = st["p"]
    jct, tct = st["ct_v"]
    jh = jla.hoisted_rotations(p.jctx, jct, STEPS + [0], st["jgks"])
    th = tla.hoisted_rotations(p.tctx, tct, STEPS + [0], st["tgks"])
    assert th[0] is tct
    for step in STEPS:
        eq_ct(jh[step], th[step])
        elt = p.tctx.rotation_element(step)
        jplain = jops.rotate(p.jctx, jct, step, st["jgks"][elt])
        tplain = tops.rotate(p.tctx, tct, step, st["tgks"][elt])
        eq_ct(jplain, tplain)
        want = np.roll(st["v"], -step)
        np.testing.assert_allclose(p.decode(th[step]), want, atol=5e-3)
        np.testing.assert_allclose(p.decode(th[step]), p.decode(tplain),
                                   atol=1e-3)


@pytest.mark.parametrize("hoist", [True, False])
def test_matvec_bsgs_bit_equal(st, hoist):
    p = st["p"]
    jct, tct = st["ct_v"]
    jout = jla.matvec_bsgs(p.jctx, jct, st["jdiags"], st["jmk"], p.jcode,
                           use_hoisting=hoist)
    tout = tla.matvec_bsgs(p.tctx, tct, st["tdiags"], st["tmk"], p.tcode,
                           use_hoisting=hoist)
    eq_ct(jout, tout)
    np.testing.assert_allclose(p.decode(tout), st["mat"] @ st["v"],
                               atol=2e-2)


def test_poly_eval_power_basis_bit_equal(st):
    p = st["p"]
    jct, tct = st["ct_x"]
    coeffs = [0.25, 1.5, 0.0, -0.5]
    jout = jla.poly_eval_power_basis(p.jctx, jct, coeffs, st["jrk"], p.jcode)
    tout = tla.poly_eval_power_basis(p.tctx, tct, coeffs, st["trk"], p.tcode)
    eq_ct(jout, tout)
    x = st["x"]
    np.testing.assert_allclose(p.decode(tout).real,
                               0.25 + 1.5 * x - 0.5 * x ** 3, atol=1e-3)


def test_poly_eval_chebyshev_bit_equal(st):
    p = st["p"]
    jct, tct = st["ct_x"]
    # deg 7 fits the 4-level budget (ladder depth 3 + combination 1)
    fn = lambda t: np.sin(0.5 * np.pi * t)  # noqa: E731
    cheb = tla.chebyshev_coeffs(fn, 7)
    jout = jla.poly_eval_chebyshev(p.jctx, jct, cheb, st["jrk"], p.jcode)
    tout = tla.poly_eval_chebyshev(p.tctx, tct, cheb, st["trk"], p.tcode)
    eq_ct(jout, tout)
    np.testing.assert_allclose(p.decode(tout).real, fn(st["x"]), atol=5e-3)


def test_adjust_to_and_constants_bit_equal(st):
    p = st["p"]
    jct, tct = st["ct_v"]
    target = SCALE * 1.01
    jout = jla.adjust_to(p.jctx, p.jcode, jct, jct.level - 1, target)
    tout = tla.adjust_to(p.tctx, p.tcode, tct, tct.level - 1, target)
    eq_ct(jout, tout)
    assert tout.level == tct.level - 1 and tout.scale == target
    np.testing.assert_allclose(p.decode(tout), st["v"], atol=1e-3)
    for c in (0.5, -0.5j, 1.0 / 3.0):
        jm = jla.mul_const(p.jctx, p.jcode, jct, c)
        tm = tla.mul_const(p.tctx, p.tcode, tct, c)
        eq_ct(jm, tm)
        np.testing.assert_allclose(p.decode(tm), c * st["v"], atol=1e-3)
    ja = jla.add_const(p.jctx, p.jcode, jct, -1.0)
    ta = tla.add_const(p.tctx, p.tcode, tct, -1.0)
    eq_ct(ja, ta)


def test_hoisted_rotations_keep_batch_dims(st):
    """The port keeps leading batch dimensions: a batch of two ciphertexts
    rotates to the stack of each one's rotation."""
    p = st["p"]
    _, t0 = st["ct_v"]
    _, t1 = st["ct_x"]
    batch = t0.copy()
    batch.data = torch.stack([t0.data, t1.data])
    hb = tla.hoisted_rotations(p.tctx, batch, STEPS, st["tgks"])
    for step in STEPS:
        for k, one in enumerate((t0, t1)):
            h1 = tla.hoisted_rotations(p.tctx, one, [step], st["tgks"])
            assert torch.equal(hb[step].data[k], h1[step].data)
