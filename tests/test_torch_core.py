"""Parity of the PyTorch port's CKKS core (src/repro_torch/core) with the
JAX reference (src/repro/core), on the CPU at the conftest's small
parameters.

Everything integer is held bit for bit (``assert_array_equal``): tables,
NTTs, keys, ciphertexts and every homomorphic op. Decode alone gets a
tolerance, atol = 1e-9 relative to the reference decode: both sides run
the same numpy FFT on equal integer data, so any difference could only
come from float evaluation order, never from the ciphertext arithmetic.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import ops as jops  # noqa: E402
from repro.core.ciphertext import Ciphertext as JCt  # noqa: E402
from repro.core.ciphertext import Plaintext as JPt  # noqa: E402
from repro.core.context import CkksContext as JCtx  # noqa: E402
from repro.core.encoder import CkksEncoder as JEncoder  # noqa: E402
from repro.core.encryptor import CkksEncryptor as JEnc  # noqa: E402
from repro.core.params import test_params as j_test_params  # noqa: E402
from repro_torch.core import ops as tops  # noqa: E402
from repro_torch.core.carry import context_tables, from_reference  # noqa: E402
from repro_torch.core.ciphertext import Ciphertext as TCt  # noqa: E402
from repro_torch.core.ciphertext import Plaintext as TPt  # noqa: E402
from repro_torch.core.context import CkksContext as TCtx  # noqa: E402
from repro_torch.core.encoder import CkksEncoder as TEncoder  # noqa: E402
from repro_torch.core.encryptor import CkksEncryptor as TEnc  # noqa: E402
from repro_torch.core.params import test_params as t_test_params  # noqa: E402

PARAMS = dict(log_n=8, n_levels=4, dnum=2, log_scale=26)
LEVEL = 4


def as_np(x) -> np.ndarray:
    """Either package's residues as int64 numpy."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy().astype(np.int64)
    return np.asarray(x).astype(np.int64)


def eq(a, b):
    np.testing.assert_array_equal(as_np(a), as_np(b))


def to_t(x) -> torch.Tensor:
    return torch.from_numpy(as_np(x))


@pytest.fixture(scope="module")
def pair():
    """Reference and port stacks with keys carried from the reference,
    two ciphertexts and a plaintext at LEVEL (from the reference)."""
    jctx = JCtx(j_test_params(**PARAMS))
    tctx = TCtx(t_test_params(**PARAMS), "cpu")
    jenc = JEnc(jctx, seed=7)
    sk = jenc.keygen()
    rk = jenc.relin_keygen(sk)
    elts = [jctx.rotation_element(1), jctx.rotation_element(5),
            jctx.conj_element]
    gks = jenc.galois_keygen(sk, elts)
    jcode = JEncoder(jctx)
    rng = np.random.default_rng(3)
    scale = 2.0 ** PARAMS["log_scale"]

    def pt(level):
        v = rng.uniform(-1, 1, jctx.params.slots)
        return JPt(jcode.encode(v, scale, level), level, scale)

    cts = [jenc.encrypt_sk(pt(LEVEL), sk) for _ in range(2)]
    carried = from_reference(
        tctx, s_ntt=np.asarray(sk.s_ntt), rk=np.asarray(rk.data),
        gks={k: np.asarray(v.data) for k, v in gks.items()},
        tables=context_tables(jctx))
    return dict(jctx=jctx, tctx=tctx, sk=sk, rk=rk, gks=gks, cts=cts,
                pt=pt(LEVEL), carried=carried, elts=elts, jenc=jenc,
                jcode=jcode, scale=scale)


def test_context_tables_equal(pair):
    jctx, tctx = pair["jctx"], pair["tctx"]
    assert jctx.primes == tctx.primes
    mine, ref = context_tables(tctx), context_tables(jctx)
    for name in ref:
        eq(mine[name], ref[name])
    for level in range(1, LEVEL + 1):
        eq(tctx.qlast_inv(level), jctx.qlast_inv(level))
    for src, dst in ([[0, 1], [2, 3, 5, 6]], [tctx.p_idx(), [0, 1, 2]]):
        jt, tt = jctx.bconv_tables(src, dst), tctx.bconv_tables(src, dst)
        for f in ("qhat_inv", "w", "src_q", "dst_q"):
            eq(getattr(tt, f), getattr(jt, f))
    for elt in pair["elts"] + [jctx.rotation_element(-3)]:
        eq(tctx.eval_perm(elt), jctx.eval_perm(elt))


def test_carry_rejects_other_tables(pair):
    tables = context_tables(pair["jctx"])
    tables["root_powers"] = tables["root_powers"] + 1
    with pytest.raises(ValueError, match="root_powers"):
        from_reference(pair["tctx"], tables=tables)


@pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
def test_ntt_intt_equal(pair, lead):
    jctx, tctx = pair["jctx"], pair["tctx"]
    idx = [0, 2, 3, tctx.p_idx()[-1]]
    rng = np.random.default_rng(len(lead))
    a = np.stack([rng.integers(0, jctx.primes[i], size=lead + (jctx.n,),
                               dtype=np.uint64) for i in idx], -2)
    eq(tctx.ntt(to_t(a), idx), jctx.ntt(jnp.asarray(a), idx))
    eq(tctx.intt(to_t(a), idx), jctx.intt(jnp.asarray(a), idx))


def test_keygen_and_encryption_bit_identical():
    """Same seed, same draw order: the port's own keys and ciphertexts
    equal the reference's, array for array."""
    jctx = JCtx(j_test_params(**PARAMS))
    tctx = TCtx(t_test_params(**PARAMS), "cpu")
    jenc, tenc = JEnc(jctx, seed=7), TEnc(tctx, seed=7)
    jsk, tsk = jenc.keygen(), tenc.keygen()
    eq(tsk.s_ntt, jsk.s_ntt)
    eq(tsk.s_coeff_ternary, jsk.s_coeff_ternary)
    eq(tenc.relin_keygen(tsk).data, jenc.relin_keygen(jsk).data)
    elts = [jctx.rotation_element(2), jctx.conj_element]
    jg, tg = jenc.galois_keygen(jsk, elts), tenc.galois_keygen(tsk, elts)
    for e in elts:
        eq(tg[e].data, jg[e].data)
    jg, tg = (jenc.rotation_keygen(jsk, [1, -1]),
              tenc.rotation_keygen(tsk, [1, -1]))
    assert sorted(tg) == sorted(jg)
    for e in jg:
        eq(tg[e].data, jg[e].data)
    jpk, tpk = jenc.public_keygen(jsk), tenc.public_keygen(tsk)
    eq(tpk.data, jpk.data)
    v = np.random.default_rng(1).uniform(-1, 1, jctx.params.slots)
    scale = 2.0 ** PARAMS["log_scale"]
    jpt = JEncoder(jctx).encode(v, scale, 3)
    tpt = TEncoder(tctx).encode(v, scale, 3)
    eq(tpt, jpt)
    eq(tenc.encrypt_sk(TPt(tpt, 3, scale), tsk).data,
       jenc.encrypt_sk(JPt(jpt, 3, scale), jsk).data)
    eq(tenc.encrypt_pk(TPt(tpt, 3, scale), tpk).data,
       jenc.encrypt_pk(JPt(jpt, 3, scale), jpk).data)


def _both(pair, name):
    """Run op `name` on the reference and on the port (inputs carried
    from the reference); return both outputs' data."""
    jctx, tctx, c = pair["jctx"], pair["tctx"], pair["carried"]
    j0, j1 = pair["cts"]
    jpt = pair["pt"]
    t0, t1 = (TCt(to_t(ct.data), ct.level, ct.scale) for ct in (j0, j1))
    tpt = TPt(to_t(jpt.data), jpt.level, jpt.scale)
    rot, conj = pair["elts"][0], pair["elts"][2]
    low = TCt(t1.data[:, :3], 2, t1.scale), JCt(j1.data[:, :3], 2, j1.scale)
    runs = {
        "hadd": (lambda: jops.hadd(jctx, j0, j1),
                 lambda: tops.hadd(tctx, t0, t1)),
        "hadd_levels": (lambda: jops.hadd(jctx, j0, low[1]),
                        lambda: tops.hadd(tctx, t0, low[0])),
        "hsub": (lambda: jops.hsub(jctx, j0, j1),
                 lambda: tops.hsub(tctx, t0, t1)),
        "hneg": (lambda: jops.hneg(jctx, j0), lambda: tops.hneg(tctx, t0)),
        "padd": (lambda: jops.padd(jctx, j0, jpt),
                 lambda: tops.padd(tctx, t0, tpt)),
        "pmul": (lambda: jops.pmul(jctx, j0, jpt),
                 lambda: tops.pmul(tctx, t0, tpt)),
        "pmul_scalar_int": (lambda: jops.pmul_scalar_int(jctx, j0, -3),
                            lambda: tops.pmul_scalar_int(tctx, t0, -3)),
        "hmul": (lambda: jops.hmul(jctx, j0, j1, pair["rk"]),
                 lambda: tops.hmul(tctx, t0, t1, c.rk)),
        "hmul_lazy": (lambda: jops.hmul(jctx, j0, j1, pair["rk"], False),
                      lambda: tops.hmul(tctx, t0, t1, c.rk, False)),
        "hsquare": (lambda: jops.hsquare(jctx, j0, pair["rk"]),
                    lambda: tops.hsquare(tctx, t0, c.rk)),
        "rescale": (lambda: jops.rescale(jctx, j0),
                    lambda: tops.rescale(tctx, t0)),
        "key_switch": (
            lambda: jnp.stack(jops.key_switch(jctx, j0.data[1], LEVEL,
                                              pair["rk"])),
            lambda: torch.stack(tops.key_switch(tctx, t0.data[1], LEVEL,
                                                c.rk))),
        "rotate": (lambda: jops.rotate(jctx, j0, 1, pair["gks"][rot]),
                   lambda: tops.rotate(tctx, t0, 1, c.gks[rot])),
        "conjugate": (lambda: jops.conjugate(jctx, j0, pair["gks"][conj]),
                      lambda: tops.conjugate(tctx, t0, c.gks[conj])),
        "rotate_coeff_domain": (
            lambda: jops.rotate_coeff_domain(jctx, j0, 1, pair["gks"][rot]),
            lambda: tops.rotate_coeff_domain(tctx, t0, 1, c.gks[rot])),
    }
    jf, tf = runs[name]
    jo, to = jf(), tf()
    if isinstance(jo, JCt):
        assert (to.level, to.scale) == (jo.level, jo.scale)
        return jo.data, to.data
    return jo, to


@pytest.mark.parametrize("name", [
    "hadd", "hadd_levels", "hsub", "hneg", "padd", "pmul",
    "pmul_scalar_int", "hmul",
    "hmul_lazy", "hsquare", "rescale", "key_switch", "rotate",
    "conjugate", "rotate_coeff_domain"])
def test_op_bit_equal(pair, name):
    jo, to = _both(pair, name)
    eq(to, jo)


def test_batched_ops_equal_per_row(pair):
    """The port's ops take a leading batch dimension (the reference's
    vmap written out); each row equals the single-ciphertext op."""
    tctx, c = pair["tctx"], pair["carried"]
    j0, j1 = pair["cts"]
    b0 = torch.stack([to_t(j0.data), to_t(j1.data)])
    b1 = torch.stack([to_t(j1.data), to_t(j0.data)])
    out = tops.hmul(tctx, TCt(b0, LEVEL, j0.scale), TCt(b1, LEVEL, j1.scale),
                    c.rk)
    rot = pair["elts"][0]
    out_r = tops.rotate(tctx, TCt(b0, LEVEL, j0.scale), 1, c.gks[rot])
    for i, (x, y) in enumerate(((j0, j1), (j1, j0))):
        eq(out.data[i], jops.hmul(pair["jctx"], x, y, pair["rk"]).data)
        eq(out_r.data[i],
           jops.rotate(pair["jctx"], x, 1, pair["gks"][rot]).data)


def test_decode_within_tolerance(pair):
    jctx, tctx = pair["jctx"], pair["tctx"]
    jcode, tcode = pair["jcode"], TEncoder(tctx)
    j0 = pair["cts"][0]
    jm = pair["jenc"].decrypt(j0, pair["sk"])
    tm = TPt(to_t(jm.data), jm.level, jm.scale)
    for level, data in ((LEVEL, (jm.data, tm.data)),
                        (0, (jm.data[:1], tm.data[:1]))):
        ref = jcode.decode(data[0], pair["scale"], level)
        got = tcode.decode(data[1], pair["scale"], level)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)
